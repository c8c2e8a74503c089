"""The port's dense LM (``repro_torch.models.{common,attention,mlp,
transformer}``) against the reference's ``repro.models``: each function on
the same inputs, drawn from a numpy seed, and ``LM.loss`` with its
gradient on the reference's own parameters converted to the port's flat
vector (``convert.flat_from_tree``).

Float32 bounds, each about ten times what a CPU run measured
(JAX 0.9.0, torch 2.13): norms, rope, activations, both attention
branches, ``self_attention`` and ``mlp`` within 2e-6 of the largest
reference value (measured at most 2.1e-7); the reduced LM's loss within
1e-6 relative (1.5e-7) and its gradient within 1e-5 of the largest entry
(1.1e-6).  bfloat16: XLA:CPU and torch sum bfloat16 products in other
orders, so the loss is held within 1e-3 relative (measured 4.1e-5); the
elementwise steps around the round (``w - eta * g``, the float32 delta,
``w + d.astype(w.dtype)``) are bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import apply_overrides as japply
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.synthetic import token_batch as jtoken_batch
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.config import MLAConfig, RecurrentConfig, apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.core import fl as tfl
from repro_torch.data.synthetic import token_batch
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp

#: the size of the reference's trainer test (tests/test_launch.py)
SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
         "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512")
SEQ = 32
F32 = ("model.dtype=float32",)
#: a dense config through the other branches: rmsnorm, separate head, q/k/v
#: biases, plain relu2 MLP, grouped kv heads, a sliding window
VARIANT = SMALL + F32 + ("model.norm_type=rmsnorm", "model.tie_embeddings=false",
                         "model.qkv_bias=true", "model.gated_mlp=false",
                         "model.activation=relu2", "model.n_kv_heads=2",
                         "model.attention_window=8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(overrides):
    return (japply(jreduced(jget_config("olmo-1b")), overrides),
            apply_overrides(reduced(get_config("olmo-1b")), overrides))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, what=""):
    """|got - want| <= rtol · max |want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err)


def test_olmo_1b_width_and_flat_order():
    """olmo-1b as published: D = 1,176,764,416, the port's leaf shapes sum
    to the reference's ``param_count``."""
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    assert model.num_params == cfg.model.param_count() == 1_176_764_416
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
        jget_config("olmo-1b").model)
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(
        jget_config("olmo-1b").train)
    assert model.dtype == torch.bfloat16


@pytest.mark.parametrize("overrides", [SMALL, VARIANT])
def test_flat_order_is_tree_leaves_order(overrides):
    """The sorted "/"-joined paths of the port are the reference's
    ``tree_leaves`` order, leaf for leaf with the same shapes, and the
    converted vector is the leaves concatenated in that order."""
    jcfg, tcfg = _configs(overrides)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    paths = ["/".join(k.key for k in path) for path, _ in leaves]
    model = build_model(tcfg)
    assert paths == list(model.param_shapes)
    assert [tuple(v.shape) for _, v in leaves] == list(model.param_shapes.values())
    assert model.num_params == sum(v.size for _, v in leaves)
    if overrides == SMALL:   # param_count leaves out norm scales and biases
        assert model.num_params == tcfg.model.param_count()
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    want = np.concatenate([np.asarray(v, np.float32).ravel() for _, v in leaves])
    assert flat.dtype == torch.float32 and np.array_equal(flat.numpy(), want)


def test_bf16_leaves_convert_exactly():
    """A bfloat16 leaf reaches numpy as ``ml_dtypes.bfloat16``; through
    float32 it lands bit for bit in a bfloat16 vector."""
    jcfg, tcfg = _configs(SMALL)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    leaves = jax.tree_util.tree_leaves(jp)
    assert all(v.dtype == jnp.bfloat16 for v in leaves)
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  dtype=torch.bfloat16, device="cpu")
    want = np.concatenate([_np(v).ravel() for v in leaves])
    assert flat.dtype == torch.bfloat16
    assert np.array_equal(flat.float().numpy(), want)


def test_port_init_has_the_reference_statistics():
    """The port draws its own parameters (a parity test converts the
    reference's): the same leaves, dtype, scales and norm constants."""
    _, tcfg = _configs(VARIANT)
    model = build_model(tcfg)
    p = model.init(0, device="cpu")
    assert list(p) == list(model.param_shapes)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["blocks/mlp/w_up"].std()) - 128 ** -0.5) < 5e-3
    assert abs(float(p["blocks/mlp/w_down"].std()) - 256 ** -0.5) < 5e-3
    assert not p["blocks/attn/bq"].any() and not p["final_norm/scale"].any()
    assert torch.equal(model.init_flat(0, device="cpu"),
                       convert.flatten_params(p))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match(norm):
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 2.0, (3, 5, 64)).astype(np.float32)
    scale = rng.normal(0, 0.3, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    jcfg, tcfg = _configs(SMALL + (f"model.norm_type={norm}",))
    jp = {"rmsnorm": {"scale": scale}, "layernorm": {"scale": scale, "bias": bias},
          "nonparametric_ln": {}}[norm]
    want = jcommon.apply_norm(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, jp), jcfg.model)
    got = tcommon.apply_norm(_t(x), {k: _t(v) for k, v in jp.items()}, tcfg.model)
    _close(got, want, 2e-6, norm)
    made = tcommon.make_norm_params(tcfg.model, 64, device="cpu")
    jmade = jcommon.make_norm_params(None, jcfg.model, 64)
    assert sorted(made) == sorted(jmade)
    for k, v in made.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmade[k]))
    # the per-cohort form: a (C, d) parameter against (C, ..., d)
    if jp:
        stacked = {k: _t(np.stack([v, 2 * v])) for k, v in jp.items()}
        got2 = tcommon.apply_norm(_t(np.stack([x, x])), stacked, tcfg.model)
        assert torch.equal(got2[0], got)


def test_rope_and_activations_match():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 3, (2, 1))
    _close(tcommon.apply_rope(_t(x), _t(pos), 10000.0),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), 2e-6)
    _close(tcommon.rope_frequencies(16, 500.0, device="cpu"),
           jcommon.rope_frequencies(16, 500.0), 1e-7)
    for name in ("silu", "gelu", "relu", "relu2"):
        _close(tcommon.activation_fn(name)(_t(x)),
               jcommon.activation_fn(name)(jnp.asarray(x)), 2e-6, name)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("chunks", [None, (8, 16), (16, 8)])
def test_attention_both_branches_match(chunks, window):
    """The one-einsum path at the defaults, the chunked online softmax with
    small q/kv chunks (padding both: 45 is no multiple of 8 or 16), with
    and without a window; GQA with 2 query heads a kv head; an invalid
    (-1) kv slot."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 45, 4, 2, 8
    q = rng.normal(0, 1, (B, S, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_pos = pos.copy()
    kv_pos[1, 3] = -1
    kw = dict(causal=True, window=window)
    if chunks:
        kw.update(q_chunk=chunks[0], kv_chunk=chunks[1])
        assert S * S > chunks[0] * chunks[1] * 4 and S >= chunks[0]
    want = jcommon.attention(*(jnp.asarray(a) for a in (q, k, v, pos, kv_pos)),
                             **kw)
    got = tcommon.attention(*(_t(a) for a in (q, k, v, pos, kv_pos)), **kw)
    _close(got, want, 2e-6, (chunks, window))


def _init_sub(jfn, cfg, seed):
    return jax.tree_util.tree_map(np.asarray, jfn(jax.random.PRNGKey(seed),
                                                  cfg.model))


@pytest.mark.parametrize("overrides", [SMALL + F32, VARIANT])
def test_self_attention_and_mlp_match(overrides):
    """``self_attention`` (projections, biases, rope, causal window) and
    ``mlp`` (gated silu, plain relu2) on the reference's parameters; and
    the stacked form: two cohorts' weights against x (2, B, S, d)."""
    jcfg, tcfg = _configs(overrides)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, SEQ, 128)).astype(np.float32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (2, 1))
    window = tcfg.model.attention_window
    pa = _init_sub(jattn.init_attention_params, jcfg, 5)
    if tcfg.model.qkv_bias:
        pa = {k: (v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                  if k.startswith("b") else v) for k, v in pa.items()}
    want, (wk, _) = jattn.self_attention(pa, jnp.asarray(x), jnp.asarray(pos),
                                         jcfg.model, window=window)
    tpa = {k: _t(v) for k, v in pa.items()}
    got, (gk, _) = tattn.self_attention(tpa, _t(x), _t(pos), tcfg.model,
                                        window=window)
    _close(got, want, 2e-6, "self_attention")
    _close(gk, wk, 2e-6, "rope'd k")
    stacked = {k: torch.stack([v, 0.5 * v]) for k, v in tpa.items()}
    got2, _ = tattn.self_attention(stacked, torch.stack([_t(x), _t(x)]),
                                   _t(pos), tcfg.model, window=window)
    np.testing.assert_allclose(got2[0].numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)

    pm = _init_sub(jmlp.init_mlp_params, jcfg, 6)
    want = jmlp.mlp(pm, jnp.asarray(x), jcfg.model)
    got = tmlp.mlp({k: _t(v) for k, v in pm.items()}, _t(x), tcfg.model)
    _close(got, want, 2e-6, "mlp")


def _lm_inputs(overrides, seed=0):
    jcfg, tcfg = _configs(overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  dtype=model.dtype, device="cpu")
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tcfg.model.vocab_size, (4, SEQ)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    return jmodel, model, jp, flat, batch


@pytest.mark.parametrize("overrides", [SMALL + F32, VARIANT])
def test_lm_loss_and_gradient_match_in_float32(overrides):
    """``LM.loss`` and its gradient against ``jax.value_and_grad`` of the
    reference's, on its parameters; remat changes no number."""
    jmodel, model, jp, flat, batch = _lm_inputs(overrides)
    (jl, _), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: _t(v) for k, v in batch.items()}
    grads = {}
    for remat in (True, False):
        live = {k: v.clone().requires_grad_(True) for k, v in
                convert.unflatten_params(flat, model.param_shapes).items()}
        loss, m = model.loss(live, tb, remat=remat)
        loss.backward()
        grads[remat] = convert.flatten_params({k: v.grad for k, v in live.items()})
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
        assert torch.equal(m["ce"], loss)
    assert torch.equal(grads[True], grads[False])
    want = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jg),
                                  device="cpu")
    _close(grads[True], want.numpy(), 1e-5, "gradient")


def test_loss_stacked_is_one_loss_per_cohort():
    """Two cohorts' parameters and batches stacked give each cohort its own
    loss and gradient, as ``loss`` gives them one at a time."""
    _, model, _, flat, batch = _lm_inputs(SMALL + F32)
    flat2 = flat * 0.9
    tb = {k: _t(v) for k, v in batch.items()}
    tb2 = {k: torch.roll(v, 1, 0) for k, v in tb.items()}
    p = torch.stack([flat, flat2]).requires_grad_(True)
    ce, acc = model.loss_stacked(
        convert.unflatten_params(p, model.param_shapes),
        {k: torch.stack([tb[k], tb2[k]]) for k in tb})
    (g,) = torch.autograd.grad(ce.sum(), p)
    for c, (fp, b) in enumerate(((flat, tb), (flat2, tb2))):
        q = fp.clone().requires_grad_(True)
        one, _ = model.loss(convert.unflatten_params(q, model.param_shapes), b)
        (g1,) = torch.autograd.grad(one, q)
        np.testing.assert_allclose(float(ce[c].detach()), float(one.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(g[c].numpy(), g1.numpy(), rtol=0,
                                   atol=1e-6 * float(g1.abs().max()))
        assert 0.0 <= float(acc[c]) <= 1.0


def test_lm_loss_in_bfloat16_within_its_bound():
    """olmo's own dtype: the loss on the reference's bfloat16 parameters
    within 1e-3 relative (the two backends sum bfloat16 products in other
    orders)."""
    jmodel, model, jp, flat, batch = _lm_inputs(SMALL, seed=3)
    assert flat.dtype == torch.bfloat16
    jl, _ = jmodel.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = model.loss(convert.unflatten_params(flat, model.param_shapes),
                       {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)


def test_bfloat16_step_delta_and_apply_are_bit_exact():
    """The round's elementwise steps in bfloat16, on the same operands as
    the reference's jitted expressions: the local step ``w - eta *
    g.astype(w.dtype)`` (``fl.sgd_step_`` on a loss whose gradient is g),
    the delta ``(p - w).astype(f32)`` and the apply ``w + d.astype(w.dtype)``
    (``fl._apply``)."""
    rng = np.random.default_rng(5)
    n, eta = 100_003, 0.001
    w = jnp.asarray(rng.normal(0, 0.05, n), jnp.bfloat16)
    g = jnp.asarray(rng.normal(0, 1.0, n), jnp.bfloat16)
    d = jnp.asarray(rng.normal(0, 1e-3, n), jnp.float32)
    step = jax.jit(lambda w, g: w - eta * g.astype(w.dtype))(w, g)
    delta = jax.jit(lambda a, b: (a - b).astype(jnp.float32))(step, w)
    apply = jax.jit(lambda w, d: w + d.astype(w.dtype))(w, d)

    tw = _t(_np(w)).to(torch.bfloat16)
    tg = _t(_np(g)).to(torch.bfloat16)
    new = tw.clone()
    teta = float(torch.tensor(eta, dtype=torch.bfloat16))
    layout = convert.Layout.uniform({"w": (n,)}, torch.bfloat16)
    tfl.sgd_step_(lambda p: ((p["w"] * tg).sum(), None), new, layout, teta)
    assert np.array_equal(new.float().numpy(), _np(step))
    tdelta = new.to(torch.float32).sub_(tw)
    assert np.array_equal(tdelta.numpy(), np.asarray(delta))
    assert np.array_equal(
        tfl._apply(tw, _t(np.asarray(d)), layout).float().numpy(), _np(apply))


def test_token_batch_is_the_references_stream():
    """Shapes, dtype, range, labels the tokens shifted left, and the
    successor structure: every token is a draw or (draw·31 + 7) mod V."""
    gen = torch.Generator().manual_seed(0)
    b = token_batch(gen, 4, 16, 50)
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    assert b["tokens"].dtype == torch.int32
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, 1))
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50
    jb = jtoken_batch(jax.random.PRNGKey(0), 4, 16, 50)
    assert jb["tokens"].dtype == jnp.int32 and jb["tokens"].shape == (4, 16)
    b2 = token_batch(torch.Generator().manual_seed(0), 4, 16, 50)
    assert torch.equal(b["tokens"], b2["tokens"])


def test_other_families_raise_naming_a13():
    """The families and fields the port once refused (naming ROADMAP A13)
    now build at olmo-1b's widths, and ``reduced`` keeps each as the
    reference's ``reduced`` does, field for field."""
    cfg = get_config("olmo-1b")
    for field, value in (("family", "vlm"), ("mtp_depth", 1),
                         ("is_encoder_decoder", True),
                         ("mla", MLAConfig(enabled=True))):
        other = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **{field: value}))
        build_model(other)
        jother = japply(jget_config("olmo-1b"), (
            f"model.{field}={value}" if field != "mla"
            else "model.mla.enabled=true",))
        assert (dataclasses.asdict(reduced(other).model)
                == dataclasses.asdict(jreduced(jother).model))
        build_model(reduced(other))
    # recurrent blocks are ported: olmo-1b's widths as an RWKV-6 stack
    rec = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, recurrent=RecurrentConfig(kind="rwkv6")))
    assert build_model(reduced(rec)).kinds == ("rwkv6", "rwkv6")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_parametric_norm_outside_float32_raises_naming_a13(norm):
    """The reference keeps norm scales and biases in float32 beside
    bfloat16 weights.  Such a config raised while the port's flat vector
    had one dtype; with a dtype per leaf it builds, its norm leaves in a
    float32 buffer beside the bfloat16 one, and in float32 it is one
    flat vector again."""
    cfg = apply_overrides(get_config("olmo-1b"), (f"model.norm_type={norm}",))
    assert cfg.model.dtype == "bfloat16"
    for c in (cfg, reduced(cfg)):
        layout = build_model(c).param_shapes
        assert layout.buffer_dtypes == (torch.bfloat16, torch.float32)
        assert {k for k, dt in layout.dtypes.items()
                if dt == torch.float32} == {k for k in layout if "norm" in k}
    ok = apply_overrides(cfg, ("model.dtype=float32",))
    assert build_model(ok).dtype == torch.float32
    assert build_model(ok).param_shapes.buffer_dtypes == (torch.float32,)
