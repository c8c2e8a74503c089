"""The port's kernels against the JAX Pallas kernels they replace.

Each plain PyTorch version (``repro_torch/kernels/ref.py``, what a CPU
tensor runs) is held to the Pallas kernel in interpret mode and to
``repro/kernels/ref.py`` on the same numpy inputs.  The CUDA kernels are
held to the plain versions by the ``gpu`` test, which needs a card.

The JAX reference is imported by a fixture, not at the top, so that the
``gpu`` test also runs where JAX is not installed
(``pytest -m gpu --noconftest tests/test_torch_kernels.py``).
"""
import types

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
    # the sums run in another order; atol 1e-6 is for updates of unit
    # scale, so it grows with the int codes' magnitude (cancellation)
    atol = 1e-6 * max(1.0, float(np.abs(upd).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=atol)


def test_aggregate_all_zero_weights_gives_zero(jx):
    upd = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    w = np.zeros(4, np.float32)
    want = np.asarray(jx.aggregate(jx.jnp.asarray(upd), jx.jnp.asarray(w),
                                       interpret=True))
    got = ops.masked_aggregate(torch.from_numpy(upd), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)


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
        for bits in BITS:
            for clip in (1.0, 0.3):
                for stochastic in (True, False):
                    before = ops.LAUNCHES["stochastic_quantize_codes"]
                    got = ops.stochastic_quantize_codes(x, u, bits, clip=clip,
                                                        stochastic=stochastic)
                    assert ops.LAUNCHES["stochastic_quantize_codes"] == before + 1
                    want = tref.stochastic_quantize_ref(x, u, bits, clip=clip,
                                                        stochastic=stochastic)
                    assert torch.equal(got, want), (K, D, bits, clip, stochastic)
                    deq = ops.dequantize_codes(got, bits, clip=clip)
                    assert torch.equal(deq, tref.dequantize_ref(got, bits, clip=clip))
        w = torch.rand(K, generator=gen, device=dev)
        for upd in (x, torch.randint(-128, 128, (K, D), generator=gen, device=dev,
                                     dtype=torch.int32)):
            for wts in (w, torch.zeros_like(w)):
                got = ops.masked_aggregate(upd, wts)
                atol = 1e-6 * max(1.0, float(upd.abs().max()))
                torch.testing.assert_close(got, tref.masked_aggregate_ref(upd, wts),
                                           rtol=1e-5, atol=atol)
        torch.cuda.synchronize()
