"""whisper-base on the port (``repro_torch.models.whisper``, the
cross-attention of ``models.attention``, its cache in ``convert``,
``launch.inputs``, ``launch.steps``, ``launch.serve`` and the cohort
round with frames) against the reference's ``repro.models.whisper`` on
the reference's ``reduced`` widths (2 encoder and 2 decoder layers,
d_model 256, 4 heads, 64 frames, layernorm, plain gelu MLP), from the
reference's own parameters (``convert.flat_from_tree``) and inputs from a
numpy seed.

Float32 bounds: cross-attention, the encoder (one model and C = 2
stacked) within 1e-5 of the largest reference value; the loss within
1e-5 relative and the gradient within 1e-4 of each leaf's largest entry;
prefill, 3 decode steps from the reference's cache and every cache entry
within 1e-5 of its largest value.  bfloat16 (float32 layernorm scales and
biases): the loss within 2e-2 relative, serving within 2e-2 of the
largest.  One int round at C = 2 with frames on the reference's uplink
noise (``RoundNoise``): every parameter within a code step, 99.9 % within
1e-5 (ROADMAP C4's bound); the quantized formats ``torch.equal``.
Checkpoints and converted caches byte for byte.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.config.base import apply_overrides as japply
from repro.core import aggregation as jagg
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.obs.sinks import validate_record
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.launch import train as ttrain
from repro_torch.models import WhisperModel, build_model
from repro_torch.models import attention as tattn

ARCH = "whisper-base"
F32 = ("model.dtype=float32",)
B, SEQ, STEPS = 2, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jp)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _near(got, want, tol, what=""):
    """Every entry within ``tol`` of ``want``'s largest magnitude."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _model(overrides=F32, seed=0):
    jcfg = japply(jconfigs.reduced(jconfigs.get_config(ARCH)), overrides)
    tcfg = apply_overrides(tconfigs.reduced(tconfigs.get_config(ARCH)),
                           overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    return jcfg, tcfg, jmodel, model, jp, flat


def _batch(cfg, seed=0, n=B, seq=SEQ):
    rng = np.random.default_rng(seed)
    m = cfg.model
    tok = rng.integers(0, m.vocab_size, (n, seq)).astype(np.int32)
    frames = rng.standard_normal((n, m.encoder_seq_len, m.d_model))
    return {"tokens": tok, "labels": np.roll(tok, -1, 1),
            "frames": frames.astype(np.float32)}


# ---------------------------------------------------------------------------
# layout and modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_layout_is_the_reference_tree(reduce):
    """Paths, shapes and dtypes in ``tree_leaves`` order ("dec", "embed",
    "enc", "enc_norm", "final_norm", "head"), the layernorm leaves float32;
    whisper-base's D is 97,182,720."""
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    if reduce:
        j, t = jconfigs.reduced(j), tconfigs.reduced(t)
    model = build_model(t)
    assert isinstance(model, WhisperModel)
    layout = model.param_shapes
    want = convert.tree_paths(jax.eval_shape(jbuild_model(j).init,
                                             jax.random.PRNGKey(0)))
    assert list(layout) == list(want)
    for k, v in want.items():
        assert layout[k] == tuple(v.shape), k
        assert str(layout.dtypes[k]).removeprefix("torch.") == str(v.dtype), k
    tops = list(dict.fromkeys(k.split("/")[0] for k in layout))
    assert tops == ["dec", "embed", "enc", "enc_norm", "final_norm", "head"]
    if not reduce:
        assert model.num_params == 97_182_720
        assert layout.buffer_dtypes == (torch.bfloat16, torch.float32)


def test_cross_attention_and_projection_match():
    """``project_cross_kv`` and ``cross_attention`` (every position 0, no
    mask, no rope) on layer 0's cross-attention, float32."""
    jcfg, tcfg, _, model, jp, flat = _model()
    jparams = jax.tree_util.tree_map(lambda x: x[0], jp["dec"]["cross_attn"])
    tparams = {k: torch.from_numpy(np.array(v))
               for k, v in _tree(jparams).items()}
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((B, 64, 256)).astype(np.float32)
    x = rng.standard_normal((B, SEQ, 256)).astype(np.float32)
    jk, jv = jattn.project_cross_kv(jparams, jnp.asarray(enc), jcfg.model)
    k, v = tattn.project_cross_kv(tparams, torch.from_numpy(enc), tcfg.model)
    _near(k, jk, 1e-5, "k")
    _near(v, jv, 1e-5, "v")
    jo = jattn.cross_attention(jparams, jnp.asarray(x), jk, jv, jcfg.model)
    o = tattn.cross_attention(tparams, torch.from_numpy(x), k, v, tcfg.model)
    _near(o, jo, 1e-5, "cross attention")


def test_encoder_matches_one_and_stacked():
    """``encode``: non-causal self-attention with rope on q and k, and
    the MLP, a layer, then ``enc_norm``; C = 2 stacked (cohort 1's leaves
    scaled) gives each cohort's own encoding."""
    jcfg, tcfg, jmodel, model, jp, flat = _model()
    params = convert.unflatten_params(flat, model.param_shapes)
    frames = _batch(tcfg)["frames"]
    want = jmodel.encode(jp, jnp.asarray(frames))
    got = model.encode(params, torch.from_numpy(frames))
    _near(got, want, 1e-5, "encode")
    f2 = frames[::-1].copy()
    stacked = {k: torch.stack([v, v * 1.05]) for k, v in params.items()}
    sgot = model.encode(stacked, torch.from_numpy(np.stack([frames, f2])),
                        stacked=True)
    _near(sgot[0], want, 1e-5, "stacked 0")
    want1 = jmodel.encode(jax.tree_util.tree_map(lambda w: w * 1.05, jp),
                          jnp.asarray(f2))
    _near(sgot[1], want1, 1e-5, "stacked 1")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_loss_and_gradient_match_in_float32():
    """The decoder's cross-entropy given the frames within 1e-5 relative;
    every leaf's gradient within 1e-4 of its largest entry; the metrics
    {"ce"}, as the reference's."""
    _, tcfg, jmodel, model, jp, flat = _model()
    batch = _batch(tcfg)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    loss, m = model.loss(live, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert set(m) == set(jm) == {"ce"}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = convert.tree_paths(_tree(jg))
    for k, v in live.items():
        _near(v.grad, want[k], 1e-4, k)


def test_loss_stacked_and_bfloat16():
    """``loss_stacked`` on C = 2 cohorts (tokens, labels and frames with a
    leading 2) gives each cohort's ``loss``; in bfloat16 with float32
    layernorms the loss is within 2e-2 relative of the reference's."""
    _, tcfg, _, model, _, flat = _model()
    leaves = convert.unflatten_params(flat, model.param_shapes)
    scaled = {k: v * 1.05 for k, v in leaves.items()}
    b0, b1 = _batch(tcfg, 0), _batch(tcfg, 1)
    total, acc = model.loss_stacked(
        {k: torch.stack([leaves[k], scaled[k]]) for k in leaves},
        {k: torch.from_numpy(np.stack([b0[k], b1[k]])) for k in b0})
    for c, (p, b) in enumerate(((leaves, b0), (scaled, b1))):
        want, _ = model.loss(p, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(total[c]), float(want), rtol=1e-5)
    assert acc.shape == (2,)
    _, tcfg, jmodel, model, jp, flat = _model(())
    assert model.param_shapes.buffer_dtypes == (torch.bfloat16, torch.float32)
    batch = _batch(tcfg)
    jl, _ = jmodel.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = model.loss(convert.unflatten_params(flat, model.param_shapes),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

#: (overrides, max_len, tolerance)
SERVE_CASES = {"f32": (F32, 0, 1e-5), "f32_max_len": (F32, SEQ + 8, 1e-5),
               "bf16_max_len": ((), SEQ + 8, 2e-2)}


def _check_cache(cache, jcache, tol, what):
    got = convert.cache_to_reference(cache)
    for name in ("k", "v", "cross_k", "cross_v"):
        _near(got[name], jcache[name], tol, f"{what} {name}")
    assert np.array_equal(got["kv_pos"], np.asarray(jcache["kv_pos"]))
    assert got["length"] == int(jcache["length"])


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_prefill_and_decode_match_reference(case):
    """``prefill(params, tokens, frames, max_len=)``: the last logits and
    the cache (self k and v padded to max_len, the cross k and v of every
    layer); then 3 decode steps from the reference's cache carried over,
    the logits and the cache after each."""
    overrides, max_len, tol = SERVE_CASES[case]
    _, tcfg, jmodel, model, jp, flat = _model(overrides)
    params = convert.unflatten_params(flat, model.param_shapes)
    batch = _batch(tcfg, 2)
    toks, frames = batch["tokens"], batch["frames"]
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), jnp.asarray(frames), max_len=max_len)
    prefill = steps.make_prefill_step(model, tcfg)
    logits, cache = prefill(params, torch.from_numpy(toks),
                            torch.from_numpy(frames), max_len=max_len)
    C = max(max_len, SEQ)
    assert cache["k"].shape == (2, B, C, 4, 64)
    assert cache["cross_k"].shape == (2, B, 64, 4, 64)
    assert cache["k"].dtype == model.dtype
    _near(logits, jlogits, tol, "prefill logits")
    _check_cache(cache, jcache, tol, "prefill")
    cache = convert.cache_from_reference(_tree(jcache), model.dtype,
                                         device="cpu")
    decode = steps.make_decode_step(model, tcfg)
    jdecode = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(3)
    for step in range(STEPS):
        tok = rng.integers(0, tcfg.model.vocab_size, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        logits, cache = decode(params, cache, torch.from_numpy(tok))
        assert logits.shape == (B, 1, tcfg.model.vocab_size)
        _near(logits, jlogits, tol, f"decode {step} logits")
        _check_cache(cache, jcache, tol, f"decode {step}")


def test_decode_matches_teacher_forced():
    """On the port alone: prefill of 16 tokens, then decoding tokens
    16..23 one at a time gives the teacher-forced decoder's logits at
    each position within 1e-5 of their largest value."""
    _, tcfg, _, model, _, flat = _model()
    params = convert.unflatten_params(flat, model.param_shapes)
    batch = _batch(tcfg, 4)
    toks, frames = (torch.from_numpy(batch[k]) for k in ("tokens", "frames"))
    full = model._decoder_full(params, toks, model.encode(params, frames))
    logits, cache = model.prefill(params, toks[:, :16], frames, max_len=SEQ)
    _near(logits, full[:, 15].numpy(), 1e-5, "prefill")
    for t in range(16, SEQ):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        _near(logits[:, 0], full[:, t].numpy(), 1e-5, f"position {t}")
    assert int(cache["length"]) == SEQ


def test_cache_conversions_round_trip():
    """whisper's cache {k, v, cross_k, cross_v, kv_pos, length} into the
    port's and back is byte for byte the reference's float32 arrays; the
    port's there and back is ``torch.equal``; ``init_cache`` has the
    reference's shapes and dtypes."""
    _, tcfg, jmodel, model, jp, flat = _model()
    batch = _batch(tcfg)
    _, jcache = jmodel.prefill(jp, jnp.asarray(batch["tokens"]),
                               jnp.asarray(batch["frames"]), max_len=SEQ + 4)
    jc = _tree(jcache)
    tc = convert.cache_from_reference(jc, torch.float32, device="cpu")
    assert set(tc) == set(jc)
    back = convert.cache_to_reference(tc)
    for k in jc:
        assert np.asarray(back[k]).tobytes() == np.asarray(jc[k]).tobytes(), k
    again = convert.cache_from_reference(back, torch.float32, device="cpu")
    assert all(torch.equal(tc[k], again[k]) for k in tc)
    empty = model.init_cache(3, 40, device="meta")
    jempty = jax.eval_shape(lambda: jmodel.init_cache(3, 40))
    for k, v in jempty.items():
        assert tuple(empty[k].shape) == v.shape, k
        assert str(empty[k].dtype).removeprefix("torch.") == str(v.dtype), k


# ---------------------------------------------------------------------------
# the round, the checkpoint, the launchers
# ---------------------------------------------------------------------------

C, I, GB, LR = 2, 2, 8, 0.5


def test_cohort_round_matches_the_reference(monkeypatch):
    """Reduced float32 whisper-base through one int round at C = 2, I = 2,
    lr 0.5, both cohorts kept, its batch carrying frames: against the
    reference's local steps and ``agg.aggregate`` under ``vmap`` on its
    own uplink noise, every parameter within a code step (1/128), 99.9 %
    within 1e-5, the loss within 1e-4 relative.  Each float32 leaf
    (the layernorms') steps in one ``fma_step_`` call a local step."""
    over = F32 + (f"fl.local_iters={I}", f"fl.learning_rate={LR}",
                  f"train.global_batch={GB}", f"train.seq_len={SEQ}")
    jcfg, tcfg, jmodel, model, jp, flat = _model(over, seed=1)
    batch = _batch(tcfg, 6, GB)
    micro = {k: jnp.asarray(v.reshape(C, I, GB // C // I, *v.shape[1:]))
             for k, v in batch.items()}
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

    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jloss, u = jax.jit(jax.vmap(one, axis_name="data"))(micro, keys)
    jnew = jax.tree_util.tree_map(lambda x: x[0], jnew)
    fn = make_fl_round(model, tcfg, (C,), collective="int", device="cpu")
    new, m = fn(flat, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=RoundNoise(None, torch.from_numpy(np.array(u)),
                                 torch.ones(C)))
    got = new.numpy()
    want = convert.flat_from_tree(_tree(jnew), device="cpu").numpy()
    assert np.abs(want - flat.numpy()).max() > 1 / 128
    diff = np.abs(got - want)
    assert diff.max() <= 1 / 128 + 1e-7, diff.max()
    assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
    np.testing.assert_allclose(float(m["loss"]), float(jloss[0]), rtol=1e-4)

    # bfloat16 with float32 layernorms: one fma_step_ a float32 leaf a step
    # and the quantized formats equal
    tcfg = apply_overrides(tconfigs.reduced(tconfigs.get_config(ARCH)),
                           over[1:])
    model = build_model(tcfg)
    flat = model.init_flat(0, device="cpu")
    n32 = sum(dt == torch.float32 for dt in model.param_shapes.dtypes.values())
    assert n32 == 14
    calls = []
    fma_step_ = ops.fma_step_
    monkeypatch.setattr(ops, "fma_step_", lambda w, g, eta: (
        calls.append(w.dtype), fma_step_(w, g, eta))[1])
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 7, GB).items()}
    outs = {}
    for mode in ("int", "packed", "ring", "rsag"):
        calls.clear()
        fn = make_fl_round(model, tcfg, (C,), collective=mode, device="cpu")
        new, m = fn(flat, tb, torch.Generator().manual_seed(3))
        assert calls == [torch.float32] * (n32 * I)
        assert np.isfinite(float(m["loss"]))
        outs[mode] = new
    for mode, new in outs.items():
        assert all(torch.equal(a, b) for a, b in zip(new, outs["int"])), mode


def test_checkpoint_is_the_references_file(tmp_path):
    """bfloat16 weights with float32 layernorms: the port's file is byte
    for byte the reference's, and each restores the other's."""
    _, _, _, model, jp, flat = _model(())
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jp)
    tckpt.save_params(str(tmp_path / "t"), 1, flat, model.param_shapes)
    assert ((tmp_path / "t" / "ckpt_1.msgpack").read_bytes()
            == (tmp_path / "j" / "ckpt_1.msgpack").read_bytes())
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


TINY = ("model.n_layers=2", "model.n_encoder_layers=2", "model.d_model=128",
        "model.n_heads=4", "model.n_kv_heads=4", "model.d_ff=256",
        "model.vocab_size=512", "model.encoder_seq_len=64")


def test_serve_main_and_trainer_refusal(tmp_path):
    """``launch.serve.main --arch whisper-base`` on the CPU at a tiny
    size: frames drawn from the port's generator, the cache sized for the
    prompt and the new tokens, one valid ``serve_decode`` record a step.
    The trainer refuses the encoder-decoder: its token batches carry no
    frames (the reference's trainer cannot train it either)."""
    out = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "4", "--telemetry-dir", str(tmp_path),
                      *TINY], device="cpu")
    assert out["length"] == 12 and tuple(out["tokens"].shape) == (2, 5)
    records = [json.loads(line) for line in
               open(tmp_path / "telemetry.jsonl")]
    assert len(records) == 4
    assert all(validate_record(r) == [] for r in records)
    with pytest.raises(NotImplementedError, match="frames"):
        ttrain.main(["--arch", ARCH, "--steps", "1", *TINY], device="cpu")
