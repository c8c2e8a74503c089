"""The recurrent families on the port (``repro_torch.models.rwkv``,
``models.griffin``, the ``rwkv6``, ``recurrent`` and ``local_attention``
blocks of ``models.transformer``, their caches and ``convert``) against
the reference's ``repro.models``: rwkv6-7b (RWKV-6, family ssm) and
recurrentgemma-2b (the Griffin hybrid) on the reference's ``reduced``
widths, the hybrid also at 5 and 12 layers, where its local-attention
layers and a layer index past 9 show (the reduced config's 2 layers are
both recurrent).

Float32 bounds, each about ten times what a CPU run measured (JAX 0.9.0,
torch 2.13): the modules (``time_mix``, ``channel_mix``, ``rwkv_block``,
``_causal_conv``, ``_rg_lru``, ``recurrent_block``, from nonzero states,
for one model and for C = 2 stacked cohorts) within 1e-5 of the largest
reference value (measured 1.1e-6); the LM's loss within 2e-6 relative
and its gradient within 1e-5 of the largest entry (rwkv's 1e-4, ROADMAP
C7); prefill and 3 decode steps from the reference's cache within 1e-5
of each entry's largest value (logits and every cache entry; measured
2.9e-6).
bfloat16: the loss within 1e-3 relative, as ``test_torch_lm.py`` holds
olmo-1b's; rwkv's time-mix from the first mix on runs in float32 (JAX
promotes the float32 ``mu_base``), and the port's output is held to the
reference's op-by-op run within 2e-4 of the largest value, where
bfloat16 products would be off by more than 1e-3.

The round's elementwise steps on both mixed layouts are bit for bit; the
C = 2 cohort round is held as ``test_torch_leaf_dtypes.py`` holds qwen's
(gradient sums run in ATen's order, ROADMAP C4); the hybrid's mixed
checkpoint is byte for byte the reference's file.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.config.base import apply_overrides as japply
from repro.configs import shapes as jshapes
from repro.core import aggregation as jagg
from repro.models import build_model as jbuild_model
from repro.models import griffin as jgriffin
from repro.models import rwkv as jrwkv
from repro.utils import flops as jflops
from repro_torch import checkpoint as tckpt
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.config.base import COLLECTIVE_CHOICES
from repro_torch.configs import shapes as tshapes
from repro_torch.core import fl as tfl
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import griffin as tgriffin
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttransformer
from repro_torch.utils import flops as tflops

RWKV, GRIFFIN = "rwkv6-7b", "recurrentgemma-2b"
F32 = ("model.dtype=float32",)
#: the hybrid with local-attention layers: (rec, rec, att, rec, rec)
FIVE = ("model.n_layers=5",)
B, SEQ = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, overrides=()):
    return (japply(jconfigs.reduced(jconfigs.get_config(arch)), overrides),
            apply_overrides(tconfigs.reduced(tconfigs.get_config(arch)),
                            overrides))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jp)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _near(got, want, tol, what=""):
    """Within ``tol`` of the reference's largest magnitude."""
    got, want = np.asarray(got.detach().float()), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, GRIFFIN])
def test_configs_are_the_references(arch):
    """Field for field, full and reduced (``reduced``'s ``rec`` clause:
    d_rnn = d); ``build_model`` builds both, in bfloat16."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for sec in ("model", "train"):
        assert dataclasses.asdict(getattr(t, sec)) == \
            dataclasses.asdict(getattr(j, sec))
    rj, rt = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(rt.model) == dataclasses.asdict(rj.model)
    assert dataclasses.asdict(rt.train) == dataclasses.asdict(rj.train)
    assert t.model.dtype == "bfloat16"
    assert tconfigs.is_subquadratic(t)
    assert t.model.family in tconfigs.PORTED_FAMILIES
    build_model(t)
    assert build_model(rt).num_params == sum(
        x.size for x in jax.tree_util.tree_leaves(
            jbuild_model(rj).init(jax.random.PRNGKey(0))))


def _port_config(jcfg):
    """The reference's config as the port's dataclasses, field for field."""
    m = dataclasses.asdict(jcfg.model)
    for name, cls in (("moe", tconfig.MoEConfig), ("mla", tconfig.MLAConfig),
                      ("recurrent", tconfig.RecurrentConfig)):
        m[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in m[name].items()})
    return tconfig.Config(model=tconfig.ModelConfig(**m))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-base",
                                  "chameleon-34b"])
def test_check_ported_still_refuses_the_rest(arch):
    """The last three configs of the zoo, which the port refused until it
    built MLA with MTP, the encoder-decoder and the vlm family: the
    port's registered config is the reference's field for field, full and
    reduced (MLA's reduced ranks), and ``build_model`` builds both, with
    the reference's parameter count at the reduced size."""
    j = jconfigs.get_config(arch)
    cfg = _port_config(j)
    t = tconfigs.get_config(arch)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(cfg.model)
    for sec in ("model", "train"):
        assert dataclasses.asdict(getattr(t, sec)) == \
            dataclasses.asdict(getattr(j, sec))
    assert t.fl.cohort_axes == j.fl.cohort_axes
    rj, rt = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(rt.model) == dataclasses.asdict(rj.model)
    assert t.model.family in tconfigs.PORTED_FAMILIES
    build_model(cfg)
    assert build_model(rt).num_params == sum(
        x.size for x in jax.tree_util.tree_leaves(
            jax.eval_shape(jbuild_model(rj).init, jax.random.PRNGKey(0))))


# ---------------------------------------------------------------------------
# modules, on random parameters from a numpy seed
# ---------------------------------------------------------------------------

#: the float32 leaves' draws: uniform on [lo, hi)
_F32_RANGES = {"mu_base": (0, 1), "decay_base": (-5, -1), "bonus_u": (-1, 1),
               "ln_x_scale": (0.5, 1.5), "cm_mu_k": (0, 1), "cm_mu_r": (0, 1),
               "conv_b": (-0.5, 0.5), "b_a": (-1, 1), "b_i": (-1, 1),
               "lam": (0, 4)}


def _params(shapes, f32, rng, dtype, C=None):
    """(reference leaves, port leaves): the matrices N(0, 1/fan_in) in
    ``dtype`` (``conv_w`` times 0.1), the float32 leaves uniform; with
    ``C`` a leading cohort dim on every port leaf, the reference's leaves
    then each cohort's."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    lead = () if C is None else (C,)
    jp, tp = {}, {}
    for k, s in shapes.items():
        if k in f32:
            a = rng.uniform(*_F32_RANGES[k], lead + s).astype(np.float32)
            jp[k], tp[k] = jnp.asarray(a), torch.from_numpy(a)
            continue
        a = rng.normal(0, s[-2] ** -0.5 if len(s) > 1 else 1, lead + s)
        a = jnp.asarray(a * (0.1 if k == "conv_w" else 1.0), jdt)
        jp[k], tp[k] = a, _t(a, dtype)
    return jp, tp


def _cohort(jp, c):
    return {k: v[c] for k, v in jp.items()}


def _norm(cfg, rng, C=None):
    lead = () if C is None else (C,)
    s = rng.uniform(0.5, 1.5, lead + (cfg.d_model,)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, lead + (cfg.d_model,)).astype(np.float32)
    return ({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
            {"scale": torch.from_numpy(s), "bias": torch.from_numpy(b)})


def _rwkv_inputs(cfg, rng, dtype, C=None):
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    lead = (B,) if C is None else (C, B)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = jnp.asarray(rng.normal(0, 1, lead + (SEQ, d)), jdt)
    S0 = jnp.asarray(rng.normal(0, 0.3, lead + (H, hd, hd)), jnp.float32)
    xt = jnp.asarray(rng.normal(0, 1, lead + (d,)), jdt)
    xc = jnp.asarray(rng.normal(0, 1, lead + (d,)), jdt)
    return (x, S0, xt, xc), (_t(x, dtype), _t(S0), _t(xt, dtype),
                             _t(xc, dtype))


@pytest.mark.parametrize("C", [None, 2], ids=["one", "stacked"])
def test_rwkv_modules_match_in_float32(C):
    """``time_mix``, ``channel_mix`` and ``rwkv_block`` from nonzero
    states: the outputs and the new states, one model and C = 2 cohorts
    stacked (each cohort against the reference on its own leaves)."""
    jcfg, tcfg = _configs(RWKV, F32)
    cfg = jcfg.model
    rng = np.random.default_rng(0)
    jp, tp = _params(trwkv.rwkv_param_shapes(tcfg.model), trwkv.FLOAT32, rng,
                     torch.float32, C)
    (x, S0, xt, xc), (tx, tS0, txt, txc) = _rwkv_inputs(cfg, rng,
                                                        torch.float32, C)
    jn1, tn1 = _norm(cfg, rng, C)
    jn2, tn2 = _norm(cfg, rng, C)
    tm = trwkv.time_mix(tp, tx, tS0, txt, tcfg.model)
    cm = trwkv.channel_mix(tp, tx, txc, tcfg.model)
    blk, st = trwkv.rwkv_block(tp, tx, tn1, tn2,
                               {"S": tS0, "x_tm": txt, "x_cm": txc}, tcfg.model)
    jtm = jax.jit(lambda p, x, s, xp: jrwkv.time_mix(p, x, s, xp, cfg))
    jcm = jax.jit(jrwkv.channel_mix)
    jblk = jax.jit(lambda p, x, n1, n2, st: jrwkv.rwkv_block(p, x, n1, n2, st,
                                                             cfg))
    for c in ([None] if C is None else range(C)):
        pick = (lambda a: a) if c is None else (lambda a: a[c])
        jpc = jp if c is None else _cohort(jp, c)
        want = jtm(jpc, pick(x), pick(S0), pick(xt))
        for got, w, what in zip(tm, want, ("out", "S", "x_tm")):
            _near(pick(got), w, 1e-5, f"time_mix {what}")
        want = jcm(jpc, pick(x), pick(xc))
        for got, w, what in zip(cm, want, ("out", "x_cm")):
            _near(pick(got), w, 1e-5, f"channel_mix {what}")
        jx, jst = jblk(jpc, pick(x), jn1 if c is None else _cohort(jn1, c),
                       jn2 if c is None else _cohort(jn2, c),
                       {"S": pick(S0), "x_tm": pick(xt), "x_cm": pick(xc)})
        _near(pick(blk), jx, 1e-5, "rwkv_block")
        for k in jst:
            _near(pick(st[k]), jst[k], 1e-5, f"rwkv_block state {k}")


def test_rwkv_time_mix_promotes_to_float32_in_bfloat16():
    """bfloat16 weights and activations, the float32 mixes: the reference
    promotes every product after the first mix to float32, and so does
    the port: its output is float32 (the reference's dtype) and within
    2e-4 of the largest value of the reference run op by op (a CPU run
    measured 2.6e-5); with the products' operands rounded to bfloat16 it
    is off by more than 1e-3.  The jitted reference is not the yardstick
    here: XLA:CPU drops a bfloat16 rounding between fused float32 ops (its
    excess precision), 2.9e-3 away from its own op-by-op result."""
    jcfg, tcfg = _configs(RWKV)
    cfg = jcfg.model
    rng = np.random.default_rng(1)
    jp, tp = _params(trwkv.rwkv_param_shapes(tcfg.model), trwkv.FLOAT32, rng,
                     torch.bfloat16)
    (x, S0, xt, _), (tx, tS0, txt, _) = _rwkv_inputs(cfg, rng, torch.bfloat16)
    out, S, x_prev = trwkv.time_mix(tp, tx, tS0, txt, tcfg.model)
    with jax.disable_jit():
        jout, jS, jx = jrwkv.time_mix(jp, x, S0, xt, cfg)
    assert jout.dtype == jnp.float32 and out.dtype == torch.float32
    assert S.dtype == torch.float32 and x_prev.dtype == torch.bfloat16
    _near(out, jout, 2e-4, "out")
    _near(S, jS, 2e-4, "S")
    assert np.array_equal(x_prev.float().numpy(), _np(jx))
    down = tcommon.promoted_linear
    try:
        tcommon.promoted_linear = lambda a, w: tcommon.linear(
            a.to(w.dtype), w).float()
        bad, _, _ = trwkv.time_mix(tp, tx, tS0, txt, tcfg.model)
    finally:
        tcommon.promoted_linear = down
    err = np.abs(bad.float().numpy() - _np(jout)).max() / np.abs(_np(jout)).max()
    assert err > 1e-3, err


def _griffin_inputs(cfg, rng, dtype, C=None):
    d = cfg.d_model
    dr = cfg.recurrent.d_rnn or d
    w = cfg.recurrent.conv1d_width
    lead = (B,) if C is None else (C, B)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = jnp.asarray(rng.normal(0, 1, lead + (SEQ, d)), jdt)
    h0 = jnp.asarray(rng.normal(0, 1, lead + (dr,)), jnp.float32)
    conv = jnp.asarray(rng.normal(0, 1, lead + (w - 1, dr)), jdt)
    return (x, h0, conv), (_t(x, dtype), _t(h0), _t(conv, dtype))


@pytest.mark.parametrize("C", [None, 2], ids=["one", "stacked"])
def test_griffin_modules_match_in_float32(C):
    """``_causal_conv``, ``_rg_lru`` and ``recurrent_block`` from nonzero
    states (the conv's history, h), one model and C = 2 stacked."""
    jcfg, tcfg = _configs(GRIFFIN, F32)
    cfg = jcfg.model
    rng = np.random.default_rng(2)
    jp, tp = _params(tgriffin.recurrent_param_shapes(tcfg.model),
                     tgriffin.FLOAT32, rng, torch.float32, C)
    (x, h0, conv), (tx, th0, tconv) = _griffin_inputs(cfg, rng, torch.float32,
                                                      C)
    got_conv = tgriffin._causal_conv(tx, tp["conv_w"], tp["conv_b"], tconv)
    got_lru = tgriffin._rg_lru(tp, tx, th0)
    got_blk = tgriffin.recurrent_block(tp, tx, {"h": th0, "conv": tconv},
                                       tcfg.model)
    jconv = jax.jit(jgriffin._causal_conv)
    jlru = jax.jit(jgriffin._rg_lru)
    jblk = jax.jit(lambda p, x, st: jgriffin.recurrent_block(p, x, st, cfg))
    for c in ([None] if C is None else range(C)):
        pick = (lambda a: a) if c is None else (lambda a: a[c])
        jpc = jp if c is None else _cohort(jp, c)
        for got, w, what in zip(got_conv, jconv(pick(x), jpc["conv_w"],
                                                jpc["conv_b"], pick(conv)),
                                ("out", "history")):
            _near(pick(got), w, 1e-5, f"_causal_conv {what}")
        for got, w, what in zip(got_lru, jlru(jpc, pick(x), pick(h0)),
                                ("y", "h")):
            _near(pick(got), w, 1e-5, f"_rg_lru {what}")
        out, st = jblk(jpc, pick(x), {"h": pick(h0), "conv": pick(conv)})
        _near(pick(got_blk[0]), out, 1e-5, "recurrent_block")
        for k in st:
            _near(pick(got_blk[1][k]), st[k], 1e-5, f"recurrent_block {k}")


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is log(1 + e^x) everywhere; ``F.softplus`` takes
    x itself above 20, a float32 ulp off there."""
    x = np.array([-30.0, -3.0, 0.0, 2.0, 19.5, 20.5, 25.0, 60.0], np.float32)
    got = tgriffin._softplus(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# the LM: layout, loss and gradient
# ---------------------------------------------------------------------------

LAYOUTS = {"rwkv": (RWKV, ()), "hybrid": (GRIFFIN, ()),
           "hybrid12": (GRIFFIN, ("model.n_layers=12",))}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_layout_is_the_reference_tree(case):
    """Paths, shapes and dtypes in ``tree_leaves`` order (the hybrid's list
    by index: "blocks/2" before "blocks/10"), each leaf's dtype the
    reference init's; the reference's parameters through
    ``flat_from_tree(dtype=None)`` and back bit for bit."""
    arch, overrides = LAYOUTS[case]
    jcfg, tcfg = _configs(arch, overrides)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    layout = build_model(tcfg).param_shapes

    def path(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        for k in p)
    assert list(layout) == [path(p) for p, _ in leaves]
    assert [layout[k] for k in layout] == [tuple(v.shape) for _, v in leaves]
    assert [str(layout.dtypes[k])[6:] for k in layout] == \
        [str(v.dtype) for _, v in leaves]
    assert set(layout.buffer_dtypes) == {torch.bfloat16, torch.float32}
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    layout.check(flat)
    views = convert.unflatten_params(flat, layout)
    for p, v in leaves:
        assert np.array_equal(views[path(p)].float().numpy(), _np(v))
    again = convert.flatten_params(views)
    assert all(torch.equal(a, b) for a, b in zip(again, flat))
    if case == "hybrid12":
        assert convert.leaf_order(["blocks/10/x", "blocks/2/x", "embed"]) == [
            "blocks/2/x", "blocks/10/x", "embed"]
        assert build_model(tcfg).kinds[2::3] == ("local_attention",) * 4


def _lm(arch, overrides, seed=0):
    jcfg, tcfg = _configs(arch, overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    return jmodel, model, jp, flat


def _batch(vocab, seed, n=4, S=SEQ):
    tok = np.random.default_rng(seed).integers(0, vocab, (n, S)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


@pytest.mark.parametrize("arch,overrides", [(RWKV, ()), (GRIFFIN, FIVE)],
                         ids=["rwkv", "hybrid5"])
def test_loss_and_gradient_match(arch, overrides):
    """Float32: the loss within 2e-6 relative (measured 0 and 1.4e-7); the
    gradient within 1e-5 of its largest entry for the hybrid, 1e-4 for
    rwkv: its scan's sums reproduce less well in float32 (measured 4.9e-5,
    at ``bonus_u``, whose gradient is the largest, 228; the reference's
    own jitted and op-by-op gradients lie 2.9e-5 apart there, ROADMAP
    C7).  bfloat16 with the reference's float32 leaves: the loss within
    1e-3 relative, each leaf's gradient in the leaf's dtype."""
    jmodel, model, jp, flat = _lm(arch, overrides + F32)
    batch = _batch(512, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jp, jb)
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    loss, _ = model.loss(live, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-6)
    got = convert.flatten_params({k: v.grad for k, v in live.items()})
    want = convert.flat_from_tree(_tree(jg), device="cpu").numpy()
    tol = 1e-4 if arch == RWKV else 1e-5
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()

    jmodel, model, jp, flat = _lm(arch, overrides)
    assert [b.dtype for b in flat] == list(model.param_shapes.buffer_dtypes)
    jl, _ = jax.jit(jmodel.loss)(jp, jb)
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    tl, _ = model.loss(live, tb)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    tl.backward()
    assert all(v.grad.dtype == model.param_shapes.dtypes[k]
               for k, v in live.items())


def test_loss_stacked_is_each_cohorts_loss():
    """``loss_stacked`` on C = 2 cohorts' leaves equals each cohort's
    ``loss`` (float32, within 1e-6 relative), the hybrid at 5 layers."""
    _, model, _, flat = _lm(GRIFFIN, FIVE + F32)
    other = flat + 0.01 * torch.randn(flat.shape, generator=torch.Generator()
                                      .manual_seed(0))
    stacked = convert.unflatten_params(torch.stack([flat, other]),
                                       model.param_shapes)
    b = [_batch(512, s) for s in (4, 5)]
    tb = {k: torch.from_numpy(np.stack([x[k] for x in b])) for k in b[0]}
    ce, acc = model.loss_stacked(stacked, tb)
    for c, f in enumerate((flat, other)):
        one, _ = model.loss(convert.unflatten_params(f, model.param_shapes),
                            {k: v[c] for k, v in tb.items()})
        np.testing.assert_allclose(float(ce[c]), float(one), rtol=1e-6)
    assert acc.shape == (2,)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

#: (arch, overrides, prompt, max_len): rwkv; the hybrid's two recurrent
#: layers; at 5 layers a window of 16 cropping a prompt of 32, and a
#: prompt of 12 padded into a cache of 16
SERVE = {"rwkv": (RWKV, (), SEQ, 0), "hybrid": (GRIFFIN, (), SEQ, SEQ + 8),
         "hybrid5_crop": (GRIFFIN, FIVE, SEQ, SEQ + 8),
         "hybrid5_pad": (GRIFFIN, FIVE, 12, 20)}


def _assert_cache(model, tcache, jcache, tol, what):
    got = convert.cache_to_reference(
        tcache, None if ttransformer.homogeneous(model.cfg) else model.kinds)
    jt, gt = _tree(jcache), got
    jl = jax.tree_util.tree_leaves_with_path(jt)
    gl = jax.tree_util.tree_leaves_with_path(gt)
    assert [p for p, _ in gl] == [p for p, _ in jl], what
    for (p, g), (_, w) in zip(gl, jl):
        if np.asarray(w).dtype.kind == "i":
            assert np.array_equal(g, np.asarray(w)), (what, p)
        else:
            _near(torch.from_numpy(g), w, tol, f"{what} {p}")


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_and_decode_match_reference(case):
    """Float32: prefill's last logits and its cache, then 3 decode steps
    from the reference's own cache carried over (``cache_from_reference``),
    the logits and the cache after each, within 1e-5; the cache's state
    sizes do not depend on the context."""
    arch, overrides, S, max_len = SERVE[case]
    jmodel, model, jp, flat = _lm(arch, overrides + F32)
    tp = convert.unflatten_params(flat, model.param_shapes)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), max_len=max_len)
    tlogits, tcache = model.prefill(tp, torch.from_numpy(toks),
                                    max_len=max_len)
    assert tlogits.shape == (B, 512) and tlogits.dtype == torch.float32
    _near(tlogits, jlogits, 1e-5, "prefill logits")
    _assert_cache(model, tcache, jcache, 1e-5, "prefill")
    small = model.init_cache(B, 8, device="meta")
    for k in ("S", "x_tm", "x_cm", "h", "conv"):
        if k in tcache:
            assert small[k].shape == tcache[k].shape, k

    tcache = convert.cache_from_reference(_tree(jcache), model.dtype,
                                          device="cpu")
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(3):
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok))
        _near(tlogits, jlogits, 1e-5, f"decode {step} logits")
        _assert_cache(model, tcache, jcache, 1e-5, f"decode {step}")
    assert int(tcache["length"]) == S + 3


def test_rwkv_prefill_runs_in_chunks(monkeypatch):
    """An RWKV-6 stack's prefill in chunks of 12 tokens (a prompt of 32:
    12, 12 and 8, each from the states the last left) against the
    reference's prefill of the whole prompt, float32, logits and cache
    within 1e-5, as the unchunked prefill is held."""
    monkeypatch.setattr(ttransformer, "PREFILL_CHUNK", 12)
    jmodel, model, jp, flat = _lm(RWKV, F32)
    tp = convert.unflatten_params(flat, model.param_shapes)
    toks = np.random.default_rng(2).integers(0, 512, (B, SEQ)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), max_len=0)
    tlogits, tcache = model.prefill(tp, torch.from_numpy(toks))
    _near(tlogits, jlogits, 1e-5, "chunked prefill logits")
    _assert_cache(model, tcache, jcache, 1e-5, "chunked prefill")
    assert int(tcache["length"]) == SEQ


@pytest.mark.parametrize("arch,overrides", [(RWKV, ()), (GRIFFIN, ()),
                                            (GRIFFIN, ("model.n_layers=3",))],
                         ids=["rwkv", "hybrid", "hybrid3"])
def test_decode_matches_teacher_forced(arch, overrides):
    """The reference's tests on the port alone, bfloat16: prefill's logits
    equal the full forward's at the last position (2e-2), and one decode
    step from a cache with headroom equals the full forward over prompt +
    token (6e-2)."""
    cfg = apply_overrides(tconfigs.reduced(tconfigs.get_config(arch)),
                          overrides)
    model = build_model(cfg)
    params = model.init(10, device="cpu")
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, 512, (B, SEQ), generator=gen, dtype=torch.int32)

    def full(t):
        h, _ = model._backbone(params, t, stacked=False, remat=False)
        return model._logits(params, h)[:, -1]

    logits_pre, cache = model.prefill(params, toks, max_len=SEQ + 4)
    np.testing.assert_allclose(logits_pre.numpy(), full(toks).numpy(),
                               rtol=2e-2, atol=2e-2)
    nxt = toks[:, :1]
    logits_dec, cache = model.decode_step(params, cache, nxt)
    np.testing.assert_allclose(logits_dec[:, 0].numpy(),
                               full(torch.cat([toks, nxt], 1)).numpy(),
                               rtol=6e-2, atol=6e-2)
    assert int(cache["length"]) == SEQ + 1


# ---------------------------------------------------------------------------
# the round on the mixed layouts
# ---------------------------------------------------------------------------

class _Dot:
    """A model whose loss is Σ_leaves Σ w·g in float32: its gradient is g
    exactly, so the step's only rounding is the update's."""
    quantizes_training = False

    def __init__(self, layout, grads):
        self.param_shapes, self.grads = layout, grads

    def loss_stacked(self, leaves, batch):
        ce = sum((leaves[k].float() * self.grads[k].float()).flatten(1).sum(-1)
                 for k in leaves)
        return ce, torch.zeros_like(ce)


def _random_tree(layout, rng, scale, C=None):
    out = {}
    for k, s in layout.items():
        a = rng.normal(0, scale, s if C is None else (C,) + s)
        dt = jnp.bfloat16 if layout.dtypes[k] == torch.bfloat16 else jnp.float32
        out[k] = np.asarray(jnp.asarray(a.astype(np.float32), dt))
    return out


def _torch_leaves(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype.name == "bfloat16" else torch.float32)
        for k, v in tree.items()}


@pytest.mark.parametrize("case", ["rwkv", "hybrid12"])
def test_step_delta_and_apply_are_bit_exact(case, monkeypatch):
    """The local step on C = 2 rows, the delta into the (C, D) float32 wire
    vector in leaf order and the apply, against the reference's jitted
    expressions, every leaf bit for bit; each float32 leaf steps in one
    ``ops.fma_step_`` call (its plain version here)."""
    arch, overrides = LAYOUTS[case]
    _, tcfg = _configs(arch, overrides + ("fl.learning_rate=0.001",
                                          "fl.local_iters=1"))
    layout = build_model(tcfg).param_shapes
    rng = np.random.default_rng(7)
    w, g = _random_tree(layout, rng, 0.05), _random_tree(layout, rng, 1.0, C=2)
    eta = 0.001
    jstep = jax.jit(lambda w, g: jax.tree_util.tree_map(
        lambda w, g: w - eta * g.astype(w.dtype), w, g))
    rows = [jstep(w, {k: g[k][c] for k in layout}) for c in range(2)]
    want = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in layout}
    flat = convert.flatten_params(_torch_leaves(w))
    calls = []
    fma_step_ = ops.fma_step_
    monkeypatch.setattr(ops, "fma_step_", lambda w, g, eta: (
        calls.append(w.dtype), fma_step_(w, g, eta))[1])
    p, _, _ = tfl.local_sgd(_Dot(layout, _torch_leaves(g)), tcfg, flat,
                            {"labels": torch.zeros(2, 1, 1)})
    n32 = sum(dt == torch.float32 for dt in layout.dtypes.values())
    assert calls == [torch.float32] * n32 and n32 > 0
    got = convert.unflatten_params(p, layout)
    for k in layout:
        assert np.array_equal(got[k].float().numpy(), _np(want[k])), k

    jdelta = jax.jit(lambda a, b: jax.tree_util.tree_map(
        lambda a, b: (a - b).astype(jnp.float32), a, b))
    drows = [jdelta({k: want[k][c] for k in layout}, w) for c in range(2)]
    dwant = np.stack([np.concatenate([np.asarray(r[k]).ravel()
                                      for k in layout]) for r in drows])
    assert np.array_equal(tfl._delta(p, flat, layout).numpy(), dwant)

    d = rng.normal(0, 1e-3, layout.numel).astype(np.float32)
    offs = np.cumsum([0] + [int(np.prod(s)) for s in layout.values()])
    dtree = {k: d[a:b].reshape(layout[k])
             for k, a, b in zip(layout, offs, offs[1:])}
    awant = jax.jit(lambda w, d: jax.tree_util.tree_map(
        lambda w, d: w + d.astype(w.dtype), w, d))(w, dtree)
    new = convert.unflatten_params(
        tfl._apply(flat, torch.from_numpy(d), layout), layout)
    for k in layout:
        assert np.array_equal(new[k].float().numpy(), _np(awant[k])), k


C, I, RB, LR = 2, 2, 8, 0.5


def _reference_round(jmodel, jcfg, jp, micro, keys):
    """The reference's cohort update for C cohorts under ``vmap`` over
    "data": I local steps, the delta, ``agg.aggregate`` in int and the
    apply; returns cohort 0's new parameters, the mean loss and each
    cohort's uplink noise."""
    plan = jagg.make_wire_plan("int", jcfg.quant, ("data",), (C,))

    def one(mb, key):
        def step(p, b):
            (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
            return jax.tree_util.tree_map(
                lambda w, g: w - LR * g.astype(w.dtype), p, g), loss
        p_local, losses = jax.lax.scan(step, jp, mb)
        delta = jax.tree_util.tree_map(
            lambda a, b: (a - b).astype(jnp.float32), p_local, jp)
        agg_d = jagg.aggregate(plan, delta, jnp.float32(1.0 / C),
                               jnp.float32(1.0), key)
        new = jax.tree_util.tree_map(lambda w, d: w + d.astype(w.dtype),
                                     jp, agg_d)
        leaves = jax.tree_util.tree_leaves(delta)
        u = jagg._flat_noise(leaves, jax.random.split(key, len(leaves)))
        return new, jax.lax.pmean(losses.mean(), "data"), u

    new, loss, u = jax.jit(jax.vmap(one, axis_name="data"))(micro, keys)
    return jax.tree_util.tree_map(lambda x: x[0], new), loss[0], u


def _values(flat):
    return np.concatenate([b.float().numpy() for b in convert.buffers(flat)])


@pytest.mark.parametrize("arch,overrides", [(RWKV, F32), (GRIFFIN, FIVE + F32),
                                            (RWKV, ())],
                         ids=["rwkv_f32", "hybrid5_f32", "rwkv_bf16"])
def test_cohort_round_matches_the_reference(arch, overrides):
    """C = 2, I = 2, int at 8 bits, lr 0.5, both cohorts kept: the port's
    round on the reference's parameters and uplink noise.  Float32 (the
    bounds ``test_torch_leaf_dtypes.py`` holds qwen's to): every parameter
    within a code step (1/128), at least 99.9 % within 1e-5, the loss
    within 1e-4 relative (measured: at most half a code step, 99.996 %
    and 99.9995 % equal).  rwkv in bfloat16 with its float32 leaves is
    held to the loss within 1e-3 relative (measured 1.5e-4), at least
    85 % of the parameters equal (measured 90.1 %) and every one within
    96 code steps and a bfloat16 ulp (measured 81): at lr 0.5 bonus_u's
    gradient reaches 228, the quantized deltas saturate at the clip, and
    the second local step amplifies each side's bfloat16 rounding; the
    reference's own op-by-op round (``jax.disable_jit``) agrees with its
    jitted one no better (90.2 % equal, up to 96 code steps apart; the
    port's jitted-side maximum is 81)."""
    mixed = F32[0] not in overrides
    run = (f"fl.local_iters={I}", f"fl.learning_rate={LR}",
           f"train.global_batch={RB}", f"train.seq_len={SEQ}")
    jmodel, model, jp, flat = _lm(arch, overrides + run, seed=1)
    jcfg, tcfg = _configs(arch, overrides + run)
    batch = _batch(512, 0, n=RB)
    micro = {k: jnp.asarray(v.reshape(C, I, RB // C // I, SEQ))
             for k, v in batch.items()}
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jloss, u = _reference_round(jmodel, jcfg, jp, micro, keys)
    fn = make_fl_round(model, tcfg, (C,), collective="int", device="cpu")
    new, m = fn(flat, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=RoundNoise(None, torch.from_numpy(np.array(u)),
                                 torch.ones(C)))
    assert [b.dtype for b in convert.buffers(new)] == list(
        model.param_shapes.buffer_dtypes)
    got, init = _values(new), _values(flat)
    want = _values(convert.flat_from_tree(_tree(jnew), dtype=None,
                                          device="cpu"))
    assert np.abs(want - init).max() > 1 / 128
    diff = np.abs(got - want)
    assert float(m["survivors"]) == 2.0
    if mixed:
        assert (diff == 0).mean() >= 0.85, (diff == 0).mean()
        assert (diff <= 96 / 128 + np.abs(want) * 2.0 ** -7).all(), \
            diff.max() * 128
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-3)
    else:
        assert diff.max() <= 1 / 128 + 1e-7, diff.max()
        assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-4)


def test_hybrid_mixed_checkpoint_is_the_references_file(tmp_path):
    """The hybrid at 12 layers in bfloat16 (its float32 norms and RG-LRU
    leaves beside, "blocks/10" after "blocks/9"): the port's file of the
    reference's parameters is byte for byte the reference's, and each
    package restores the other's."""
    jcfg, tcfg = _configs(GRIFFIN, ("model.n_layers=12",))
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jp)
    tckpt.save_params(str(tmp_path / "t"), 1, flat, model.param_shapes)
    assert (tmp_path / "t" / "ckpt_1.msgpack").read_bytes() == \
        (tmp_path / "j" / "ckpt_1.msgpack").read_bytes()
    got = tckpt.restore_params(str(tmp_path / "j"),
                               model.param_shapes.empty(device="cpu"),
                               model.param_shapes)
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    moved = tuple(b + 1 for b in flat)
    tckpt.save_params(str(tmp_path / "t"), 2, moved, model.param_shapes)
    back = convert.flat_from_tree(
        _tree(jckpt.restore_checkpoint(str(tmp_path / "t"), jp)), dtype=None,
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, moved))


# ---------------------------------------------------------------------------
# the analytic cost model
# ---------------------------------------------------------------------------

MESHES = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


@pytest.mark.parametrize("arch", [RWKV, GRIFFIN])
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_analytic_costs_match_for_the_full_configs(arch, shape):
    """``utils.flops.analytic_costs`` of the full config at the shape
    (``for_shape``: neither arch gains a window on long_500k) equal to the
    reference's field by field, over three meshes and every step kind."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    j, t = jconfigs.for_shape(j, js), tconfigs.for_shape(t, ts)
    assert t.model.attention_window == 0 == j.model.attention_window
    assert t.model.param_count() == j.model.param_count()
    kinds = ([("train/standard", "paper")]
             + [("train/fl_round", m) for m in COLLECTIVE_CHOICES]
             if js.kind == "train" else [(js.kind, "paper")])
    for sizes, axes in MESHES:
        jmesh = types.SimpleNamespace(shape=dict(zip(axes, sizes)))
        for step_kind, mode in kinds:
            want = jflops.analytic_costs(j, js, jmesh, step_kind=step_kind,
                                         collective_mode=mode)
            got = tflops.analytic_costs(t, ts, make_mesh(sizes, axes),
                                        step_kind=step_kind,
                                        collective_mode=mode)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                sizes, step_kind, mode)

