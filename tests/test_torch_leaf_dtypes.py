"""A dtype per leaf in the port's parameters (``convert.Layout``) against
the reference, which keeps norm scales and biases and the MoE router in
float32 beside the model's dtype: reduced qwen2.5-14b, yi-9b,
nemotron-4-340b and granite-moe-1b-a400m in bfloat16.

* The layout's paths, shapes and dtypes are the reference ``init``'s
  ``tree_leaves``; its flat parameters (a bfloat16 and a float32 buffer)
  round-trip through ``convert`` bit for bit.
* The elementwise steps of the round are bit for bit the reference's
  jitted expressions, leaf by leaf in each leaf's dtype: the local step
  ``w - eta * g.astype(w.dtype)`` (a float32 leaf contracted into one
  rounding, ROADMAP C5; a bfloat16 leaf a product and a difference), the
  delta ``(p - w).astype(f32)`` into the (C, D) wire vector in leaf order,
  and the apply ``w + d.astype(w.dtype)``.
* Reduced qwen2.5-14b's loss and gradient: float32 within 1e-6 (loss,
  relative) and 1e-5 (gradient, of its largest entry); the mixed bfloat16
  loss within 1e-3 relative, as ``test_torch_lm.py`` holds olmo-1b.
* One cohort round of reduced qwen2.5-14b at C = 2 in int (8 bits, lr
  0.5) against the reference's local steps and ``agg.aggregate`` under
  ``jax.vmap(axis_name="data")`` on the reference's own uplink draws, as
  ``test_torch_lm_round.py`` holds olmo-1b's.  Float32: every parameter
  within a code step (1/128), at least 99.9 % within 1e-5, the loss
  within 1e-4 relative (a CPU run measured 99.9996 % equal, at most half
  a code step apart).  bfloat16 weights with float32 norms: the local
  steps' bfloat16 products sum and round in another order on each side
  (the projections' bias adds too), so at least 97 % of the parameters
  equal and every one within two code steps and a bfloat16 ulp, the loss
  within 1e-3 relative (measured 98.2 % equal, at most 1.47 code steps
  beyond an ulp, in the embedding, which moved by up to 0.22).
* A mixed-dtype checkpoint is byte for byte the reference's file.
* The QNN and olmo-1b keep one flat tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.config.base import apply_overrides as japply
from repro.core import aggregation as jagg
from repro.models import build_model as jbuild_model
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.config.base import MLAConfig, RecurrentConfig
from repro_torch.core import fl as tfl
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.kernels import ops
from repro_torch.models import build_model

ARCHS = ("qwen2.5-14b", "yi-9b", "nemotron-4-340b", "granite-moe-1b-a400m",
         "chameleon-34b")
F32 = ("model.dtype=float32",)
SEQ = 32


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


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    """Field for field, full and reduced (nemotron keeps FSDP and its
    "pod" cohort axis); ``build_model`` builds each in bfloat16."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for sec in ("model", "train"):
        assert dataclasses.asdict(getattr(t, sec)) == \
            dataclasses.asdict(getattr(j, sec))
    assert t.fl.cohort_axes == j.fl.cohort_axes
    rj, rt = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(rt.model) == dataclasses.asdict(rj.model)
    assert dataclasses.asdict(rt.train) == dataclasses.asdict(rj.train)
    assert t.model.dtype == "bfloat16"
    build_model(t)
    build_model(rt)
    if arch == "nemotron-4-340b":
        assert t.train.fsdp and t.fl.cohort_axes == ("pod",)


def test_check_ported_still_refuses_the_rest():
    """The fields the port once refused (the vlm family, multi-token
    prediction, the encoder-decoder, MLA) now build on qwen2.5-14b's
    widths, each the model the reference's ``build_model`` builds, with
    its leaves (MTP's "mtp/...", MLA's "mla/...", whisper's "enc/..."),
    and an RWKV-6 stack whatever the family; a family outside the zoo
    raises."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen2.5-14b"))
    for field, value, leaf in (("family", "vlm", "blocks/attn/wq"),
                               ("mtp_depth", 1, "mtp/proj"),
                               ("is_encoder_decoder", True, "enc/attn/wq"),
                               ("mla", MLAConfig(enabled=True),
                                "blocks/mla/w_dkv")):
        cfg_f = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **{field: value}))
        model = build_model(cfg_f)
        jmodel = jbuild_model(japply(jconfigs.reduced(
            jconfigs.get_config("qwen2.5-14b")), (f"model.{field}={value}",)
            if field != "mla" else ("model.mla.enabled=true",)))
        assert type(model).__name__ == type(jmodel).__name__
        assert leaf in model.param_shapes
    rec = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, recurrent=RecurrentConfig(kind="rwkv6")))
    assert build_model(rec).kinds == ("rwkv6", "rwkv6")
    bad = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, family="diffusion"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_is_the_reference_tree(arch):
    """Paths, shapes and dtypes in ``tree_leaves`` order; norm leaves and
    the router float32, the rest bfloat16; the reference's parameters
    through ``flat_from_tree(dtype=None)`` and back by
    ``unflatten_params`` and ``flatten_params`` bit for bit."""
    jcfg, tcfg = _configs(arch)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    layout = build_model(tcfg).param_shapes
    assert list(layout) == ["/".join(k.key for k in p) for p, _ in leaves]
    assert [layout[k] for k in layout] == [tuple(v.shape) for _, v in leaves]
    assert [str(layout.dtypes[k])[6:] for k in layout] == \
        [str(v.dtype) for _, v in leaves]
    assert layout.buffer_dtypes == (torch.bfloat16, torch.float32)
    assert layout.numel == sum(v.size for _, v in leaves)
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    layout.check(flat)
    views = convert.unflatten_params(flat, layout)
    for (path, v) in leaves:
        got = views["/".join(k.key for k in path)]
        assert got.dtype == (torch.float32 if v.dtype == jnp.float32
                             else torch.bfloat16)
        assert np.array_equal(got.float().numpy(), _np(v))
    again = convert.flatten_params(views)
    assert all(torch.equal(a, b) for a, b in zip(again, flat))
    runs = sum(n for *_, n in layout.runs)
    assert runs == layout.numel


#: (arch, reduced, overrides): the QNN (float32), olmo-1b (bfloat16,
#: non-parametric norms) full and reduced, a float32 qwen2.5-14b
ONE_DTYPE = (("mnist_cnn", False, ()), ("olmo-1b", False, ()),
             ("olmo-1b", True, ()), ("qwen2.5-14b", True, F32))


@pytest.mark.parametrize("arch,reduce,overrides", ONE_DTYPE)
def test_one_dtype_stays_one_flat_tensor(arch, reduce, overrides):
    """Where every leaf has one dtype the layout is one buffer, one run:
    the flat parameters are one (D,) tensor, and the reduced LMs' round
    takes and returns that tensor."""
    cfg = tconfigs.get_config(arch)
    cfg = apply_overrides(tconfigs.reduced(cfg) if reduce else cfg, overrides)
    model = build_model(cfg)
    layout = model.param_shapes
    assert layout.buffer_dtypes == (model.dtype,)
    assert layout.runs == ((0, 0, 0, layout.numel),)
    if not reduce:      # the full widths: the layout alone
        assert layout.numel == {"olmo-1b": 1_176_764_416,
                                "mnist_cnn": 421_642}[arch]
        return
    flat = model.init_flat(0, device="cpu")
    assert isinstance(flat, torch.Tensor) and flat.shape == (layout.numel,)
    tok = torch.randint(0, 512, (12, SEQ), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    fn = make_fl_round(model, cfg, (2,), collective="int", device="cpu")
    new, _ = fn(flat, {"tokens": tok, "labels": torch.roll(tok, -1, 1)},
                torch.Generator().manual_seed(1))
    assert isinstance(new, torch.Tensor) and new.dtype == model.dtype


class _Dot:
    """A model whose loss is Σ_leaves Σ w·g in float32: its gradient is g
    exactly, so the step's only rounding is the update's."""
    quantizes_training = False

    def __init__(self, layout, grads):
        self.param_shapes, self.grads = layout, grads
        self.dtype = layout.buffer_dtypes[0]

    def loss_stacked(self, leaves, batch):
        ce = sum((leaves[k].float() * self.grads[k].float()).flatten(1).sum(-1)
                 for k in leaves)
        return ce, torch.zeros_like(ce)


def _random_tree(layout, rng, scale, C=None):
    """numpy leaves of each leaf's dtype (bfloat16 through jnp)."""
    out = {}
    for k, s in layout.items():
        shape = s if C is None else (C,) + s
        a = rng.normal(0, scale, shape).astype(np.float32)
        dt = jnp.bfloat16 if layout.dtypes[k] == torch.bfloat16 else jnp.float32
        out[k] = np.asarray(jnp.asarray(a, dt))
    return out


def _torch_leaves(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype.name == "bfloat16" else torch.float32)
        for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-moe-1b-a400m"])
def test_step_delta_and_apply_are_bit_exact(arch, monkeypatch):
    """The local step (``local_sgd`` on C = 2 rows), the delta and the
    apply of the round against the reference's jitted expressions on the
    same operands, every leaf bit for bit; each float32 leaf steps in one
    ``ops.fma_step_`` call (its plain version, ``fma32``, here)."""
    _, tcfg = _configs(arch)
    tcfg = dataclasses.replace(tcfg, fl=dataclasses.replace(
        tcfg.fl, learning_rate=0.001, local_iters=1))
    layout = build_model(tcfg).param_shapes
    rng = np.random.default_rng(7)
    w, g = _random_tree(layout, rng, 0.05), _random_tree(layout, rng, 1.0, C=2)
    eta = 0.001

    jstep = jax.jit(lambda w, g: jax.tree_util.tree_map(
        lambda w, g: w - eta * g.astype(w.dtype), w, g))
    rows = [jstep(w, {k: g[k][c] for k in layout}) for c in range(2)]
    want = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in layout}
    tg = _torch_leaves(g)
    flat = convert.flatten_params(_torch_leaves(w))
    calls = []
    fma_step_ = ops.fma_step_
    monkeypatch.setattr(ops, "fma_step_", lambda w, g, eta: (
        calls.append(w.dtype), fma_step_(w, g, eta))[1])
    p, _, _ = tfl.local_sgd(_Dot(layout, tg), tcfg, flat,
                            {"labels": torch.zeros(2, 1, 1)})
    n32 = sum(dt == torch.float32 for dt in layout.dtypes.values())
    assert calls == [torch.float32] * n32 and n32 > 0
    got = convert.unflatten_params(p, layout)
    for k in layout:
        assert got[k].dtype == layout.dtypes[k]
        assert np.array_equal(got[k].float().numpy(), _np(want[k])), k

    jdelta = jax.jit(lambda a, b: jax.tree_util.tree_map(
        lambda a, b: (a - b).astype(jnp.float32), a, b))
    drows = [jdelta({k: want[k][c] for k in layout}, w) for c in range(2)]
    dwant = np.stack([np.concatenate([np.asarray(r[k]).ravel()
                                      for k in layout]) for r in drows])
    delta = tfl._delta(p, flat, layout)
    assert delta.shape == (2, layout.numel) and delta.dtype == torch.float32
    assert np.array_equal(delta.numpy(), dwant)

    d = rng.normal(0, 1e-3, layout.numel).astype(np.float32)
    japply_ = jax.jit(lambda w, d: jax.tree_util.tree_map(
        lambda w, d: w + d.astype(w.dtype), w, d))
    off, dtree = 0, {}
    for k, s in layout.items():
        n = int(np.prod(s))
        dtree[k] = d[off:off + n].reshape(s)
        off += n
    awant = japply_(w, dtree)
    new = convert.unflatten_params(
        tfl._apply(flat, torch.from_numpy(d), layout), layout)
    for k in layout:
        assert new[k].dtype == layout.dtypes[k]
        assert np.array_equal(new[k].float().numpy(), _np(awant[k])), k


def _lm_inputs(overrides, seed=0):
    jcfg, tcfg = _configs("qwen2.5-14b", overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tcfg.model.vocab_size, (4, SEQ)).astype(np.int32)
    return jmodel, model, jp, flat, {"tokens": tok,
                                     "labels": np.roll(tok, -1, 1)}


def test_qwen_loss_and_gradient_match():
    """Float32: the loss within 1e-6 relative, the gradient within 1e-5
    of its largest entry; bfloat16 with float32 norms: the loss within
    1e-3 relative, the gradient of each leaf in that leaf's dtype."""
    jmodel, model, jp, flat, batch = _lm_inputs(F32)
    assert isinstance(flat, torch.Tensor)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jp, jb)
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    loss, _ = model.loss(live, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    got = convert.flatten_params({k: v.grad for k, v in live.items()})
    want = convert.flat_from_tree(_tree(jg), device="cpu").numpy()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    jmodel, model, jp, flat, batch = _lm_inputs(())
    assert [b.dtype for b in flat] == [torch.bfloat16, torch.float32]
    jl, _ = jmodel.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    tl, _ = model.loss(live, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    tl.backward()
    assert all(v.grad.dtype == model.param_shapes.dtypes[k]
               for k, v in live.items())


C, I, B, LR = 2, 2, 8, 0.5


def _reference_round(jmodel, jcfg, jp, micro, lam, keys):
    """The reference's cohort update (``make_fl_round``'s
    ``_cohort_update``) for C cohorts under ``vmap`` over "data": I local
    steps, the delta tree, ``agg.aggregate`` and the apply; returns cohort
    0's new parameters, the mean loss and each cohort's uplink noise."""
    plan = jagg.make_wire_plan("int", jcfg.quant, ("data",), (C,))

    def one(mb, lam, key):
        def step(p, b):
            (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
            return jax.tree_util.tree_map(
                lambda w, g: w - LR * g.astype(w.dtype), p, g), loss
        p_local, losses = jax.lax.scan(step, jp, mb)
        delta = jax.tree_util.tree_map(
            lambda a, b: (a - b).astype(jnp.float32), p_local, jp)
        agg_d = jagg.aggregate(plan, delta, jnp.float32(1.0 / C), lam, key)
        new = jax.tree_util.tree_map(lambda w, d: w + d.astype(w.dtype),
                                     jp, agg_d)
        leaves = jax.tree_util.tree_leaves(delta)
        u = jagg._flat_noise(leaves, jax.random.split(key, len(leaves)))
        return new, jax.lax.pmean(losses.mean(), "data"), u

    new, loss, u = jax.jit(jax.vmap(one, axis_name="data"))(micro, lam, keys)
    return jax.tree_util.tree_map(lambda x: x[0], new), loss[0], u


@pytest.mark.parametrize("overrides", [F32, ()], ids=["float32", "bfloat16"])
def test_qwen_cohort_round_matches_the_reference(overrides):
    """Reduced qwen2.5-14b, C = 2, I = 2, int at 8 bits, lr 0.5, both
    cohorts kept: the port's round on the reference's parameters and
    uplink noise within the module's bounds; in bfloat16 the float32 norm
    leaves stay float32."""
    mixed = not overrides
    overrides += (f"fl.local_iters={I}", f"fl.learning_rate={LR}",
                  f"train.global_batch={B}", f"train.seq_len={SEQ}")
    jcfg, tcfg = _configs("qwen2.5-14b", overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    micro = {k: jnp.asarray(v.reshape(C, I, B // C // I, SEQ))
             for k, v in batch.items()}
    lam = jnp.ones((C,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jloss, u = _reference_round(jmodel, jcfg, jp, micro, lam, keys)

    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    fn = make_fl_round(model, tcfg, (C,), collective="int", device="cpu")
    new, m = fn(flat, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=RoundNoise(None, torch.from_numpy(np.array(u)),
                                 torch.ones(C)))
    assert [b.dtype for b in convert.buffers(new)] == (
        [torch.bfloat16, torch.float32] if mixed else [torch.float32])
    got = np.concatenate([b.float().numpy() for b in convert.buffers(new)])
    want = np.concatenate([b.float().numpy() for b in convert.buffers(
        convert.flat_from_tree(_tree(jnew), dtype=None, device="cpu"))])
    init = np.concatenate([b.float().numpy() for b in convert.buffers(flat)])
    assert np.abs(want - init).max() > 1 / 128
    diff = np.abs(got - want)
    assert float(m["survivors"]) == 2.0
    if mixed:
        ulp = np.abs(want) * 2.0 ** -7
        assert np.all(diff <= 2 / 128 + ulp), diff.max()
        assert (diff == 0).mean() >= 0.97, (diff == 0).mean()
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-3)
    else:
        assert diff.max() <= 1 / 128 + 1e-7, diff.max()
        assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-moe-1b-a400m",
                                  "chameleon-34b"])
def test_mixed_checkpoint_is_the_references_file(tmp_path, arch):
    """The port's file of the reference's mixed parameters is byte for
    byte the reference's, and each package restores the other's: the
    port into its two buffers, bit for bit, a float32 leaf as float32.
    A file whose leaf dtypes are not the layout's raises."""
    jcfg, tcfg = _configs(arch)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jp)
    tckpt.save_params(str(tmp_path / "t"), 1, flat, model.param_shapes)
    j_bytes = (tmp_path / "j" / "ckpt_1.msgpack").read_bytes()
    assert (tmp_path / "t" / "ckpt_1.msgpack").read_bytes() == j_bytes
    template = model.param_shapes.empty(device="cpu")
    got = tckpt.restore_params(str(tmp_path / "j"), template,
                               model.param_shapes)
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    moved = tuple(b + 1 for b in flat)
    tckpt.save_params(str(tmp_path / "t"), 2, moved, model.param_shapes)
    jback = jckpt.restore_checkpoint(str(tmp_path / "t"), jp)
    assert [x.dtype for x in jax.tree_util.tree_leaves(jback)] == \
        [x.dtype for x in jax.tree_util.tree_leaves(jp)]
    back = convert.flat_from_tree(_tree(jback), dtype=None, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, moved))
    bf16 = convert.Layout.uniform(model.param_shapes, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.restore_params(str(tmp_path / "j"), bf16.empty(device="cpu"),
                             bf16)


def test_chameleon_cohort_round_matches_the_reference():
    """Reduced float32 chameleon-34b (family vlm: VQ image codes as token
    ids, 64/8 GQA at full width) through one int round at C = 2 (its
    "pod" cohort axis), I = 2, lr 0.5, both cohorts kept, against the
    reference's local steps and ``agg.aggregate`` under ``vmap`` on its
    own uplink noise: every parameter within a code step, 99.9 % within
    1e-5, the loss within 1e-4 relative, as qwen's float32 round."""
    overrides = F32 + (f"fl.local_iters={I}", f"fl.learning_rate={LR}",
                       f"train.global_batch={B}", f"train.seq_len={SEQ}")
    jcfg, tcfg = _configs("chameleon-34b", overrides)
    assert tcfg.fl.cohort_axes == ("pod",)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    micro = {k: jnp.asarray(v.reshape(C, I, B // C // I, SEQ))
             for k, v in batch.items()}
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jloss, u = _reference_round(jmodel, jcfg, jp, micro,
                                      jnp.ones((C,), jnp.float32), keys)
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    fn = make_fl_round(model, tcfg, (C,), collective="int", device="cpu")
    new, m = fn(flat, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=RoundNoise(None, torch.from_numpy(np.array(u)),
                                 torch.ones(C)))
    want = convert.flat_from_tree(_tree(jnew), device="cpu").numpy()
    assert np.abs(want - flat.numpy()).max() > 1 / 128
    diff = np.abs(new.numpy() - want)
    assert diff.max() <= 1 / 128 + 1e-7, diff.max()
    assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-4)
