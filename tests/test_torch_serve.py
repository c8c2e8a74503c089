"""Serving on the port (``LM.prefill``, ``LM.decode_step``, the cache,
``convert.cache_from_reference`` / ``cache_to_reference`` and
``launch.serve``) against the reference's ``repro.models.transformer.LM``
and ``repro.launch.serve``'s record schema.

The parity cases run reduced olmo-1b on the reference's own parameters
(``convert.flat_from_tree``) and the same tokens from a numpy seed: the
prefill's last logits and its cache (``k``, ``v``, ``kv_pos``,
``length``), then 3 decode steps from the reference's cache carried over,
with the logits and the cache after each.  Cases: float32, bfloat16, a
cache sized above the prompt (``max_len``), and a window of 16 under a
prompt of 32 (the cache cropped to the window, then the ring overwrites
its slots); and reduced chameleon-34b (family vlm, its float32 rmsnorm
scales beside bfloat16 weights) in float32 with ``max_len`` and in
bfloat16, whose logits are held within 2e-2 of the largest, as
``test_torch_moe.py`` holds granite's (its 512-wide logits in bfloat16
differ by up to 0.027, two ulps near 2, at entries near zero).  Float32 is held elementwise within rtol and atol 1e-5 (a CPU
run measured at most 3.8e-6 on the cache, 1.6e-6 on logits).  bfloat16
is held within 2e-2, as the reference's own prefill tests hold it: the
logits elementwise, the cache's k and v within 2e-2 of the largest entry
(measured 0.031 against a largest of 4.47, a bfloat16 ulp there).  Rope
and the projections round to bfloat16 in another order on each side, and
a rope output near zero carries its inputs' rounding, so an elementwise
bound on the cache would fail at a few entries near zero.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import apply_overrides as japply
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.obs.sinks import validate_record
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import build_model

B, S, STEPS = 2, 32, 3
F32 = ("model.dtype=float32",)
WINDOW = ("model.attention_window=16",)
#: (overrides, max_len, tolerance)
CASES = {
    "f32": (F32, 0, 1e-5),
    "f32_max_len": (F32, S + 8, 1e-5),
    "f32_window": (F32 + WINDOW, 0, 1e-5),
    "bf16": ((), 0, 2e-2),
    "bf16_max_len": ((), S + 8, 2e-2),
    "bf16_window": (WINDOW, 0, 2e-2),
    # chameleon-34b (vlm): a dense stack over VQ token ids, 64/8 GQA
    "chameleon_f32_max_len": (F32, S + 8, 1e-5, "chameleon-34b"),
    "chameleon_bf16": ((), 0, 2e-2, "chameleon-34b"),
}
#: the CLI size of the reference's serving docstring, olmo-1b
TINY = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
        "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), _np(want),
                               rtol=tol, atol=tol, err_msg=what)


def _assert_cache(tcache, jcache, tol, what):
    """k and v: float32 elementwise within ``tol``, bfloat16 within ``tol``
    of the largest entry; kv_pos and length equal."""
    got = convert.cache_to_reference(tcache)
    for i, name in enumerate(("k", "v")):
        if tcache[name].dtype == torch.float32:
            _close(got["layers"][i], jcache["layers"][i], tol, f"{what} {name}")
            continue
        want = _np(jcache["layers"][i])
        err = np.abs(got["layers"][i] - want).max()
        assert err <= tol * np.abs(want).max(), (what, name, err)
    assert np.array_equal(got["kv_pos"], np.asarray(jcache["kv_pos"])), what
    assert got["length"] == int(jcache["length"]), what


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    overrides, max_len, tol, arch = (CASES[case] + ("olmo-1b",))[:4]
    jcfg = japply(jreduced(jget_config(arch)), overrides)
    tcfg = apply_overrides(reduced(get_config(arch)), overrides)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)

    def close_logits(got, want, what):
        if arch == "olmo-1b" or tmodel.dtype == torch.float32:
            return _close(got, want, tol, what)
        err = np.abs(np.asarray(got, np.float32) - _np(want)).max()
        assert err <= tol * np.abs(_np(want)).max(), (what, err)

    jparams = jmodel.init(jax.random.PRNGKey(0))
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jparams),
                                  None, device="cpu")
    tparams = convert.unflatten_params(flat, tmodel.param_shapes)
    rng = np.random.default_rng(1)
    vocab = tcfg.model.vocab_size
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)

    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jparams, jnp.asarray(toks), max_len=max_len)
    tlogits, tcache = tmodel.prefill(tparams, torch.from_numpy(toks),
                                     max_len=max_len)
    assert tlogits.shape == (B, vocab) and tlogits.dtype == torch.float32
    close_logits(tlogits, jlogits, "prefill logits")
    C = {"f32_window": 16, "bf16_window": 16}.get(case, max(max_len, S))
    assert tcache["k"].shape == (2, B, C, 4, 64) and tcache["k"].dtype == tmodel.dtype
    _assert_cache(tcache, jcache, tol, "prefill cache")

    # decode from the reference's cache carried over, the same tokens
    tcache = convert.cache_from_reference(
        jax.tree_util.tree_map(np.asarray, jcache), tmodel.dtype, device="cpu")
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(STEPS):
        tok = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(tok))
        assert tlogits.shape == (B, 1, vocab)
        close_logits(tlogits, jlogits, f"decode {step} logits")
        _assert_cache(tcache, jcache, tol, f"decode {step} cache")
    assert int(tcache["length"]) == S + STEPS


def _forward_logits(model, params, toks):
    """Full-sequence logits (B, S, V) of the training forward."""
    h, _ = model._backbone(params, toks, stacked=False, remat=False)
    return model._logits(params, h)


def _olmo(seed):
    cfg = reduced(get_config("olmo-1b"))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.model.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32)
    return model, model.init(seed, device="cpu"), toks


def test_decode_consistent_with_full_forward():
    """The reference's test for olmo-1b on the port alone: prefill's logits
    equal the full forward's at the last position (bfloat16, 2e-2)."""
    model, params, toks = _olmo(4)
    logits_pre, _ = model.prefill(params, toks)
    logits_full = _forward_logits(model, params, toks)
    np.testing.assert_allclose(logits_pre.numpy(), logits_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_decode_matches_teacher_forced():
    """The reference's test for olmo-1b on the port alone: one decode step
    from a cache with headroom equals the full forward over prompt + token
    (bfloat16, 6e-2)."""
    model, params, toks = _olmo(10)
    _, cache = model.prefill(params, toks, max_len=S + 4)
    nxt = toks[:, :1]
    logits_dec, cache = model.decode_step(params, cache, nxt)
    logits_full = _forward_logits(model, params, torch.cat([toks, nxt], 1))
    np.testing.assert_allclose(logits_dec[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=6e-2, atol=6e-2)
    assert int(cache["length"]) == S + 1


def test_windowed_prefill_needs_a_multiple_of_the_window():
    cfg = apply_overrides(reduced(get_config("olmo-1b")), WINDOW)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="multiple of the window"):
        model.prefill(params, torch.zeros((1, 24), dtype=torch.int32))


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_serve_main(tmp_path, monkeypatch, telemetry):
    """``launch.serve.main`` on the CPU at the CLI size: prefill, greedy
    decode, the cache sized for prompt + new tokens; with --telemetry-dir
    one ``serve_decode`` record a step that passes the reference's
    ``validate_record``.  The run waits for the device once after prefill
    and once after the decode, and once a step only with telemetry."""
    waits = []
    real = serve.seconds_since
    monkeypatch.setattr(serve, "seconds_since",
                        lambda t0, dev: waits.append(t0) or real(t0, dev))
    new = 5
    argv = ["--arch", "olmo-1b", "--devices", "8", "--batch", "3",
            "--prompt-len", "12", "--new-tokens", str(new), *TINY]
    if telemetry:
        argv += ["--telemetry-dir", str(tmp_path)]
    out = serve.main(argv, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 4}
    assert out["tokens"].shape == (3, 1 + new) and out["length"] == 12 + new
    assert out["prefill_ms"] > 0 and out["tok_s"] > 0
    assert len(waits) == 2 + (new if telemetry else 0)
    if not telemetry:
        assert "telemetry_records" not in out
        return
    assert out["telemetry_records"] == new
    lines = (tmp_path / "telemetry.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["round"] for r in records] == list(range(new))
    for r in records:
        assert r["kind"] == "serve_decode" and validate_record(r) == []
        assert r["latency_s"] > 0 and r["tokens_per_s"] == pytest.approx(
            3 / r["latency_s"])


def test_serve_main_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "olmo-1b", *TINY])
