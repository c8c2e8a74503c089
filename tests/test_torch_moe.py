"""The port's mixture of experts (``repro_torch.models.mlp.moe`` and the MoE
stack of ``models.transformer.LM``) against the reference's
``repro.models.mlp`` and ``repro.models.transformer`` on reduced
granite-moe-1b-a400m (4 experts, 2 a token, expert d_ff 128), from the
reference's own parameters (``convert.flat_from_tree``).

Float32 bounds, with what a CPU run measured (JAX 0.9.0, torch 2.13):
``moe``'s output within 1e-5 of its largest entry (measured 6.1e-7; the
expert products and the combine sum in another order on each side) and
the load-balance loss within 1e-6 (1.2e-10); the LM's loss within 1e-6
relative (7.1e-8) and its gradient within 1e-5 of the largest entry
(1.5e-6), as ``test_torch_lm.py`` holds the dense LM; prefill and decode
logits elementwise within 1e-5 (4.5e-6), as ``test_torch_serve.py``.
In bfloat16 (float32 router and norms) the serving logits are held
within 2e-2 of the largest (measured 0.039 against 3.47, 2.5 bfloat16
ulps there: the expert products and the combine round to bfloat16 in
another order on each side), as ``test_torch_serve.py`` holds a bfloat16
cache.  Routing is exact: the chosen experts, their slots and the keep
mask are equal, also where every router logit ties (``jax.lax.top_k``
takes the lower index first, as ``mlp.top_k`` does).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import apply_overrides as japply
from repro.configs import shapes as jshapes
from repro.models import build_model as jbuild_model
from repro.models import mlp as jmlp
from repro.utils import flops as jflops
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.config.base import COLLECTIVE_CHOICES
from repro_torch.configs import shapes as tshapes
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import mlp as tmlp
from repro_torch.utils import flops as tflops

ARCH = "granite-moe-1b-a400m"
F32 = ("model.dtype=float32",)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(overrides=F32):
    return (japply(jconfigs.reduced(jconfigs.get_config(ARCH)), overrides),
            apply_overrides(tconfigs.reduced(tconfigs.get_config(ARCH)),
                            overrides))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what=""):
    """|got - want| <= rtol · max |want|, elementwise."""
    got = got.detach().float().numpy()
    want = _np(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err)


def _moe_params(jcfg, seed=0):
    """One layer's MoE leaves of the reference's init, numpy and torch."""
    jp = jmlp.init_moe_params(jax.random.PRNGKey(seed), jcfg.model,
                              dtype=jnp.dtype(jcfg.model.dtype))
    flat = convert.tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    return jp, {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in flat.items()}


def test_moe_config_reduces_as_the_reference():
    """granite as published, and ``reduced``'s MoE clause: at most 4
    experts, 2 a token, expert d_ff at most 128."""
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    rj, rt = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(rt.model) == dataclasses.asdict(rj.model)
    assert (rt.model.moe.num_experts, rt.model.moe.experts_per_token,
            rt.model.moe.expert_d_ff) == (4, 2, 128)


@pytest.mark.parametrize("tokens", [1, 4, 8, 64, 512, 1000, 1024])
def test_moe_capacity_matches(tokens):
    for arch in (ARCH,):
        for reduce in (False, True):
            j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
            if reduce:
                j, t = jconfigs.reduced(j), tconfigs.reduced(t)
            assert tmlp.moe_capacity(tokens, t.model) == \
                jmlp.moe_capacity(tokens, j.model)
    assert (tmlp.MOE_GROUP_SIZE, tmlp.MOE_CAPACITY_FACTOR) == (
        jmlp.MOE_GROUP_SIZE, jmlp.MOE_CAPACITY_FACTOR)


#: (batch, seq, router): one group of 64 tokens; two groups of 1024; a
#: router skewed to expert 0 under inputs of mean 1 (its picks overflow the
#: capacity of 40); a zero router (every logit ties: every token picks
#: experts 0 and 1)
MOE_CASES = {"one_group": (2, 32, None), "two_groups": (4, 512, None),
             "skewed": (2, 32, "skew"), "all_tie": (2, 32, "zero")}


def _router(kind, p):
    """The router (d, E) as numpy: column 0 raised by 0.05, or zeros."""
    p = np.array(p, np.float32)
    if kind == "skew":
        p[:, 0] += 0.05
    else:
        p[:] = 0.0
    return p


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_in_float32(case):
    """``moe`` on the reference's parameters within the module's bounds;
    the skewed and tied routers drop picks over capacity."""
    B, S, router = MOE_CASES[case]
    jcfg, tcfg = _configs()
    jp, tp = _moe_params(jcfg)
    if router:
        r = _router(router, jp["router"])
        jp, tp = dict(jp, router=jnp.asarray(r)), dict(tp, router=torch.from_numpy(r))
    x = np.random.default_rng(2).normal(1.0 if router == "skew" else 0.0, 1,
                                        (B, S, 256)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, x: jmlp.moe(p, x, jcfg.model))(
        jp, jnp.asarray(x))
    tout, taux = tmlp.moe(tp, torch.from_numpy(x), tcfg.model)
    assert tout.shape == (B, S, 256) and taux.shape == ()
    _close(tout, jout, 1e-5, "moe out")
    assert abs(float(taux) - float(jaux)) <= 1e-6, (float(taux), float(jaux))
    if router:
        _, _, _, _, keep = tmlp.route(
            torch.from_numpy(x).reshape(1, -1, 256) @ tp["router"],
            tcfg.model, tmlp.moe_capacity(B * S, tcfg.model))
        assert not bool(keep.all())


def _jax_route(logits, cfg, cap):
    """The reference ``moe``'s routing lines on (G, gs, E) logits: the
    chosen experts, each pick's slot and the keep mask."""
    m = cfg.moe
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, m.experts_per_token)
    sel = jax.nn.one_hot(top_e, m.num_experts, dtype=jnp.float32)
    G, gs, K, E = sel.shape
    sel_flat = sel.reshape(G, gs * K, E)
    pos = jnp.cumsum(sel_flat, axis=1) - 1.0
    pos = (pos * sel_flat).sum(-1).reshape(G, gs, K)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("tie", ["none", "pair", "all"])
def test_chosen_experts_and_keep_mask_are_equal(tie):
    """The experts, their slots and the keep mask as the reference's, on
    random logits, on logits where experts 1 and 2 tie for the second
    place, and on logits that all tie: the lower index wins a tie."""
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg.model, moe=dataclasses.replace(
        tcfg.model.moe, num_experts=8, experts_per_token=2))
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 1, (2, 64, 8)).astype(np.float32)
    if tie == "pair":
        logits -= 5.0
        logits[..., 0] = 3.0
        logits[..., 1] = logits[..., 2] = 2.0
    elif tie == "all":
        logits[:] = 0.5
    cap = tmlp.moe_capacity(64, cfg)
    want_e, want_pos, want_keep = _jax_route(jnp.asarray(logits), cfg, cap)
    _, sel, _, pos, keep = tmlp.route(torch.from_numpy(logits), cfg, cap)
    got_e = sel.argmax(-1).numpy()
    assert np.array_equal(got_e, want_e)
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(keep.numpy(), want_keep)
    if tie == "pair":
        assert (got_e == [0, 1]).all()
    if tie == "all":
        assert (got_e == [0, 1]).all() and not keep.all()
    vals, idx = tmlp.top_k(torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[2.0, 2.0, 2.0]]


def test_stacked_moe_is_two_single_calls():
    """C = 2 cohorts stacked (a leading 2 on every leaf and on x) give each
    cohort the output and aux of its own call."""
    jcfg, tcfg = _configs()
    _, p0 = _moe_params(jcfg, 0)
    _, p1 = _moe_params(jcfg, 1)
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.normal(0, 1, (2, SEQ, 256)).astype(np.float32))
          for _ in range(2)]
    out, aux = tmlp.moe({k: torch.stack([p0[k], p1[k]]) for k in p0},
                        torch.stack(xs), tcfg.model)
    assert out.shape == (2, 2, SEQ, 256) and aux.shape == (2,)
    for c, p in enumerate((p0, p1)):
        o1, a1 = tmlp.moe(p, xs[c], tcfg.model)
        np.testing.assert_allclose(out[c].numpy(), o1.numpy(), rtol=0,
                                   atol=1e-6 * float(o1.abs().max()))
        np.testing.assert_allclose(float(aux[c]), float(a1), rtol=1e-6)


def _lm_inputs(overrides=F32, seed=0):
    jcfg, tcfg = _configs(overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  dtype=None, device="cpu")
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tcfg.model.vocab_size, (4, SEQ)).astype(np.int32)
    return jmodel, model, jp, flat, {"tokens": tok,
                                     "labels": np.roll(tok, -1, 1)}


def test_lm_loss_and_gradient_match_in_float32():
    """``LM.loss`` (cross-entropy plus the layers' load-balance loss) and
    its gradient against ``jax.value_and_grad`` of the reference's; remat
    changes no number."""
    jmodel, model, jp, flat, batch = _lm_inputs()
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(jm["aux"]) > 0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (True, False):
        live = {k: v.clone().requires_grad_(True) for k, v in
                convert.unflatten_params(flat, model.param_shapes).items()}
        loss, m = model.loss(live, tb, remat=remat)
        loss.backward()
        grads[remat] = convert.flatten_params({k: v.grad for k, v in live.items()})
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
        assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= 1e-6
        np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]),
                                   rtol=1e-6)
    assert torch.equal(grads[True], grads[False])
    want = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jg),
                                  device="cpu")
    _close(grads[True], want.numpy(), 1e-5, "gradient")


def test_loss_stacked_adds_each_cohorts_aux():
    """``loss_stacked`` gives each cohort ``loss``'s total: cross-entropy
    plus its own load-balance loss."""
    _, model, _, flat, batch = _lm_inputs()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb2 = {k: torch.roll(v, 1, 0) for k, v in tb.items()}
    flat2 = flat * 0.9
    total, _ = model.loss_stacked(
        convert.unflatten_params(torch.stack([flat, flat2]), model.param_shapes),
        {k: torch.stack([tb[k], tb2[k]]) for k in tb})
    for c, (fp, b) in enumerate(((flat, tb), (flat2, tb2))):
        one, _ = model.loss(convert.unflatten_params(fp, model.param_shapes), b)
        np.testing.assert_allclose(float(total[c]), float(one), rtol=1e-6)


@pytest.mark.parametrize("overrides", [F32, ()], ids=["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(overrides):
    """Reduced granite's prefill (a cache for 3 more tokens) and 3 decode
    steps against the reference's jitted ones on its parameters: logits
    elementwise within 1e-5 in float32, within 2e-2 of the largest in
    bfloat16 (the module's bounds); the aux loss is dropped on both
    sides."""

    def held(got, want, what):
        if overrides:
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                       atol=1e-5, err_msg=what)
        else:
            _close(got, want, 2e-2, what)
    jmodel, model, jp, flat, batch = _lm_inputs(overrides, seed=1)
    tparams = convert.unflatten_params(flat, model.param_shapes)
    toks = batch["tokens"][:2]
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), max_len=SEQ + 3)
    tlogits, tcache = model.prefill(tparams, torch.from_numpy(toks),
                                    max_len=SEQ + 3)
    held(tlogits, jlogits, "prefill")
    rng = np.random.default_rng(5)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(3):
        tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tparams, tcache,
                                            torch.from_numpy(tok))
        held(tlogits, jlogits, f"decode {step}")
    assert int(tcache["length"]) == SEQ + 3


def _step_kinds(kind):
    if kind == "train":
        return ([("train/standard", "paper")]
                + [("train/fl_round", m) for m in COLLECTIVE_CHOICES])
    return [(kind, "paper")]


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "yi-9b", ARCH])
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_analytic_costs_match_for_the_full_configs(arch, shape):
    """``utils.flops.analytic_costs`` on the full config (``for_shape``'s)
    equal to the reference's field by field, on one card, the (2, 4) mesh
    and the (2, 16, 16) mesh, in every step kind; the MoE's capacity
    padding and router counted as the reference counts them."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    j, t = jconfigs.for_shape(j, js), tconfigs.for_shape(t, ts)
    assert t.model.param_count() == j.model.param_count()
    assert t.model.active_param_count() == j.model.active_param_count()
    for sizes, axes in (((1, 1), ("data", "model")),
                        ((2, 4), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        jmesh = types.SimpleNamespace(shape=dict(zip(axes, sizes)))
        for step_kind, mode in _step_kinds(js.kind):
            want = jflops.analytic_costs(j, js, jmesh, step_kind=step_kind,
                                         collective_mode=mode)
            got = tflops.analytic_costs(t, ts, make_mesh(sizes, axes),
                                        step_kind=step_kind,
                                        collective_mode=mode)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                sizes, step_kind, mode)
