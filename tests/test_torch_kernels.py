"""The port's kernels against the JAX Pallas kernels they replace.

Each plain PyTorch version (``repro_torch/kernels/ref.py``, what a CPU
tensor runs) is held to the Pallas kernel in interpret mode and to
``repro/kernels/ref.py`` on the same numpy inputs.  The CUDA kernels are
held to the plain versions by the ``gpu`` test, which needs a card.

The JAX reference is imported by a fixture, not at the top, so that the
``gpu`` test also runs where JAX is not installed
(``pytest -m gpu --noconftest tests/test_torch_kernels.py``).
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

CLIPS = [1.0, 0.3, 0.7, 2.5]
BITS = [1, 2, 4, 8]


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.aggregate import masked_aggregate
    from repro.kernels.quantize import dequantize_codes, stochastic_quantize_codes
    return types.SimpleNamespace(jnp=jnp, ref=ref, aggregate=masked_aggregate,
                                 dequantize=dequantize_codes,
                                 quantize=stochastic_quantize_codes)


def _quant_inputs(n, clip, bits, seed):
    """Uniform values over ±1.5·clip, led by the boundary cases: ±clip,
    0, values on a half step and beyond the clip."""
    rng = np.random.default_rng(seed)
    step = clip / 2 ** (bits - 1)
    x = rng.uniform(-1.5 * clip, 1.5 * clip, n).astype(np.float32)
    edge = np.array([clip, -clip, 0.0, 0.5 * step, -0.5 * step, 1.5 * step,
                     -2.5 * step, 2 * clip, -2 * clip], np.float32)
    x[:len(edge)] = edge
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:3] = [0.0, 0.5, np.nextafter(np.float32(1), np.float32(0))]
    return x, u


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_plain_bit_exact_with_pallas_and_ref(jx, bits, clip):
    for n, stochastic in ((5003, True), (5003, False), (17, True)):
        x, u = _quant_inputs(n, clip, bits, seed=bits * 100 + n)
        want = np.asarray(jx.quantize(jx.jnp.asarray(x), jx.jnp.asarray(u), bits,
                                          clip=clip, stochastic=stochastic,
                                          interpret=True))
        oracle = np.asarray(jx.ref.stochastic_quantize_ref(
            jx.jnp.asarray(x), jx.jnp.asarray(u), bits, clip=clip,
            stochastic=stochastic))
        got = ops.stochastic_quantize_codes(torch.from_numpy(x),
                                            torch.from_numpy(u), bits,
                                            clip=clip, stochastic=stochastic)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_dequantize_plain_bit_exact_with_pallas(jx, bits, clip):
    g = 2 ** (bits - 1)
    codes = np.random.default_rng(bits).integers(-g, g, 5003).astype(np.int32)
    want = np.asarray(jx.dequantize(jx.jnp.asarray(codes), bits, clip=clip,
                                        interpret=True))
    got = ops.dequantize_codes(torch.from_numpy(codes), bits, clip=clip).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the reference's pure form divides by G/clip: exact at clip 1, else
    # within one ulp of the kernel's multiply (ROADMAP C)
    oracle = np.asarray(jx.ref.dequantize_ref(jx.jnp.asarray(codes), bits, clip=clip))
    if clip == 1.0:
        np.testing.assert_array_equal(got, oracle)
    else:
        assert np.all(np.abs(got - oracle) <= np.spacing(np.abs(oracle)))


@pytest.mark.parametrize("kd", [(1, 7), (3, 5003), (10, 4099)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_aggregate_plain_matches_pallas(jx, kd, dtype):
    K, D = kd
    rng = np.random.default_rng(K * D)
    if dtype == "float32":
        upd = rng.normal(0.0, 0.01, (K, D)).astype(np.float32)
    else:
        upd = rng.integers(-128, 128, (K, D)).astype(np.int32)
    w = (rng.uniform(0.01, 0.2, K) * (rng.uniform(size=K) > 0.3)).astype(np.float32)
    w[0] = 0.1
    want = np.asarray(jx.aggregate(jx.jnp.asarray(upd), jx.jnp.asarray(w),
                                       interpret=True))
    oracle = np.asarray(jx.ref.masked_aggregate_ref(jx.jnp.asarray(upd), jx.jnp.asarray(w)))
    got = ops.masked_aggregate(torch.from_numpy(upd), torch.from_numpy(w)).numpy()
    assert got.shape == (D,) and got.dtype == np.float32
    # the plain version runs the reference's fused multiply-add chain
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_aggregate_all_zero_weights_gives_zero(jx):
    upd = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    w = np.zeros(4, np.float32)
    want = np.asarray(jx.aggregate(jx.jnp.asarray(upd), jx.jnp.asarray(w),
                                       interpret=True))
    got = ops.masked_aggregate(torch.from_numpy(upd), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)


def _quantize_np(x, u, bits, clip, stochastic):
    """The quantizer in numpy, as the reference multiplies: x clipped to
    ±float32(clip), times float32(G/clip)."""
    g = np.float32(2 ** (bits - 1))
    c = np.float32(clip)
    xq = np.clip(x, -c, c) * np.float32(2 ** (bits - 1) / clip)
    return np.clip(np.floor(xq + u) if stochastic else np.round(xq),
                   -g, g - 1).astype(np.int32)


@pytest.mark.parametrize("clip", [1.0, 0.3])
def test_quantizer_plain_against_pallas_at_24_bits(jx, clip):
    """At 24 bits a step is one ulp of x·G/clip, so the scale step's
    rounding shows.  The port multiplies by float32(G/clip), as the
    reference's oracle does; the Pallas kernel, jitted with a static clip,
    gets x·float32(1/clip) from XLA, which the power of two G makes the
    same product.  All three are bit-exact at every clip."""
    x, u = _quant_inputs(4099, clip, 24, seed=24)
    for stochastic in (True, False):
        want = np.asarray(jx.quantize(jx.jnp.asarray(x), jx.jnp.asarray(u), 24,
                                      clip=clip, stochastic=stochastic,
                                      interpret=True))
        oracle = np.asarray(jx.ref.stochastic_quantize_ref(
            jx.jnp.asarray(x), jx.jnp.asarray(u), 24, clip=clip,
            stochastic=stochastic))
        got = ops.stochastic_quantize_codes(
            torch.from_numpy(x), torch.from_numpy(u) if stochastic else None,
            24, clip=clip, stochastic=stochastic).numpy()
        np.testing.assert_array_equal(got, _quantize_np(x, u, 24, clip,
                                                        stochastic))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)
        deq = np.asarray(jx.dequantize(jx.jnp.asarray(want), 24, clip=clip,
                                       interpret=True))
        np.testing.assert_array_equal(
            ops.dequantize_codes(torch.tensor(want), 24, clip=clip).numpy(),
            deq)


def _at_offset(values: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``values`` starting ``offset`` bytes past a
    16-byte boundary (a view into a buffer 4 elements longer)."""
    buf = torch.empty(values.numel() + 4, dtype=values.dtype,
                      device=values.device)
    k = (offset - buf.data_ptr() % 16) % 16 // 4
    out = buf[k:k + values.numel()].copy_(values)
    assert out.data_ptr() % 16 == offset and out.is_contiguous()
    return out


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_output_starts_at_its_inputs_offset(offset, dtype):
    like = _at_offset(torch.arange(15, dtype=torch.float32), offset).view(3, 5)
    out = ops._empty_at_offset_of(like, dtype)
    assert out.shape == like.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == offset


#: byte offsets (x, u) of views past a 16-byte boundary: equal offsets keep
#: the kernels' 16-byte path, different ones take the scalar kernel
OFFSETS = [(0, 0), (4, 4), (8, 8), (12, 12), (4, 8), (0, 12), (12, 4)]


@pytest.mark.parametrize("ox,ou", OFFSETS)
def test_cpu_views_at_offsets_take_the_plain_versions(ox, ou):
    rng = np.random.default_rng(ox * 16 + ou)
    xs = torch.from_numpy(rng.uniform(-1.5, 1.5, 4099).astype(np.float32))
    us = torch.from_numpy(rng.uniform(0.0, 1.0, 4099).astype(np.float32))
    x, u = _at_offset(xs, ox), _at_offset(us, ou)
    ops.reset_launch_counts()
    for bits in (1, 8, 24):
        for noise in (u, None):
            got = ops.stochastic_quantize_codes(x, noise, bits, clip=0.3,
                                                stochastic=noise is not None)
            want = tref.stochastic_quantize_ref(
                xs, None if noise is None else us, bits, clip=0.3,
                stochastic=noise is not None)
            assert torch.equal(got, want)
            assert torch.equal(ops.dequantize_codes(_at_offset(got, ou), bits),
                               tref.dequantize_ref(want, bits))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.linspace(-1.2, 1.2, 101)
    u = torch.full_like(x, 0.5)
    codes = ops.stochastic_quantize_codes(x, u, 8)
    torch.testing.assert_close(codes, tref.stochastic_quantize_ref(x, u, 8),
                               rtol=0, atol=0)
    ops.dequantize_codes(codes, 8)
    ops.masked_aggregate(x.reshape(1, -1), torch.ones(1))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_wrappers_reject_bad_shapes():
    x = torch.zeros(10)
    with pytest.raises(ValueError):
        ops.stochastic_quantize_codes(x, torch.zeros(9), 8)
    with pytest.raises(ValueError):
        ops.stochastic_quantize_codes(x, None, 8)
    with pytest.raises(ValueError):
        ops.stochastic_quantize_codes(x, torch.zeros(10), 0)
    with pytest.raises(ValueError):
        ops.masked_aggregate(torch.zeros(3, 5), torch.ones(2))
    with pytest.raises(ValueError):
        ops.masked_aggregate(torch.zeros(15), torch.ones(3))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, D in ((10, 421_642), (3, 5003), (1, 7)):
        x = (torch.rand((K, D), generator=gen, device=dev) - 0.5) * 3
        u = torch.rand((K, D), generator=gen, device=dev)
        for bits in BITS + [24]:
            for clip in (1.0, 0.3):
                for stochastic in (True, False):
                    noise = u if stochastic else None
                    before = ops.LAUNCHES["stochastic_quantize_codes"]
                    got = ops.stochastic_quantize_codes(x, noise, bits, clip=clip,
                                                        stochastic=stochastic)
                    assert ops.LAUNCHES["stochastic_quantize_codes"] == before + 1
                    want = tref.stochastic_quantize_ref(x, noise, bits, clip=clip,
                                                        stochastic=stochastic)
                    assert torch.equal(got, want), (K, D, bits, clip, stochastic)
                    deq = ops.dequantize_codes(got, bits, clip=clip)
                    assert torch.equal(deq, tref.dequantize_ref(got, bits, clip=clip))
        w = torch.rand(K, generator=gen, device=dev)
        for upd in (x, torch.randint(-128, 128, (K, D), generator=gen, device=dev,
                                     dtype=torch.int32)):
            for wts in (w, torch.zeros_like(w)):
                got = ops.masked_aggregate(upd, wts)
                assert torch.equal(got, tref.masked_aggregate_ref(upd, wts)), (K, D)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_quantizer_paths_match_plain_versions():
    """Each path the quantizer's kernels take: flat sizes from aligned
    pointers (every head and tail length of the 16-byte path), views at
    equal offsets (16-byte path behind a scalar head) and at different
    ones (the scalar kernel), codes views for dequantize; bits 1, 8, 24,
    both roundings (nearest with no noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    layouts = [(n, 0, 0) for n in (1, 3, 4, 5, 7, 4099)]
    layouts += [(n, ox, ou) for n in (5, 4099) for ox, ou in OFFSETS]
    for n, ox, ou in layouts:
        x = _at_offset((torch.rand(n, generator=gen, device=dev) - 0.5) * 3, ox)
        u = _at_offset(torch.rand(n, generator=gen, device=dev), ou)
        for bits in (1, 8, 24):
            for clip in (1.0, 0.3):
                step = clip / 2 ** (bits - 1)
                edge = torch.tensor([clip, -clip, 0.0, 0.5 * step, -0.5 * step,
                                     1.5 * step, 2 * clip], device=dev)[:n]
                x[:edge.numel()] = edge
                for noise in (u, None):
                    stochastic = noise is not None
                    got = ops.stochastic_quantize_codes(x, noise, bits, clip=clip,
                                                        stochastic=stochastic)
                    plan = ops.quantizer_plan(x, noise, got)
                    assert plan.vector == (not stochastic or ox == ou), (n, ox, ou)
                    assert plan.head + 4 * plan.vectors + plan.tail == n
                    want = tref.stochastic_quantize_ref(x, noise, bits, clip=clip,
                                                        stochastic=stochastic)
                    assert torch.equal(got, want), (n, ox, ou, bits, clip, stochastic)
                    codes = _at_offset(got, ox)
                    deq = ops.dequantize_codes(codes, bits, clip=clip)
                    assert ops.quantizer_plan(codes, None, deq).vector
                    assert torch.equal(deq, tref.dequantize_ref(codes, bits, clip=clip))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_aggregate_paths_match_plain_version():
    """masked_aggregate through ``chip_smoke.py``'s ``aggregate_paths_phase``
    (its cases and plan rule live there once): every K specialisation
    (1-16) and the generic kernel (K 17, 20, 33), each load width (D = 0,
    2, 1 or 3 mod 4, and one row at any D), views 4, 8 and 12 bytes past a
    16-byte boundary, D = 1 and the edges of a tile, f32 and int32 updates,
    weights with a zero and all zero: ``torch.equal`` to the plain version,
    one launch a call, the output at the updates' offset and the plan as
    predicted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import aggregate_paths_phase

    aggregate_paths_phase(torch, ops, tref)
    torch.cuda.synchronize()
