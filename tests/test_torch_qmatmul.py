"""The port's int8 quantized matrix product against the reference's.

The plain version (``repro_torch.kernels.ref.qmatmul_ref``, what a CPU
tensor runs) is held bit-exact to the Pallas ``qmatmul`` of
``repro/kernels/qmatmul.py`` in interpret mode on the same numpy inputs;
the CUDA kernel is held to the plain version by the ``gpu`` test, which
needs a card.  ``SHAPES`` include the kernel's edge cases: K and N not
multiples of 16 (byte-wise staging), M < 16, a single element.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

SHAPES = [(64, 200, 96), (128, 128, 128), (300, 257, 130), (1, 17, 1),
          (512, 384, 256), (33, 4099, 17), (12, 96, 48)]


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import qmatmul
    return types.SimpleNamespace(jnp=jnp, qmatmul=qmatmul.qmatmul)


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (M, K)).astype(np.int8),
            rng.integers(-128, 128, (K, N)).astype(np.int8))


@pytest.mark.parametrize("mnk", SHAPES, ids=str)
def test_qmatmul_plain_bit_exact_with_pallas(jx, mnk):
    """The exact int32 product, rounded once to float32, times
    float32(sx·sw): equal to the Pallas kernel to the last bit, at scales
    whose product is inexact in float32."""
    M, K, N = mnk
    x, w = _operands(M, K, N, seed=M + K + N)
    for sx, sw in ((0.01, 0.02), (1.0, 1.0), (0.37, 3.1)):
        got = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w), sx, sw)
        want = jx.qmatmul(jx.jnp.asarray(x), jx.jnp.asarray(w),
                          jx.jnp.float32(sx), jx.jnp.float32(sw),
                          interpret=True)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qmatmul_exact_integer_accumulation(jx):
    """K = 4096 products of 127·127 sum to 66,064,384 exactly, which a
    float32 accumulation would not."""
    K = 4096
    x = np.full((8, K), 127, np.int8)
    w = np.full((K, 8), 127, np.int8)
    got = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w), 1.0, 1.0)
    want = jx.qmatmul(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.float32(1),
                      jx.jnp.float32(1), interpret=True)
    assert float(got[0, 0]) == 127 * 127 * K
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qmatmul_cpu_takes_the_plain_version_and_rejects_bad_shapes():
    ops.reset_launch_counts()
    x, w = _operands(5, 7, 3, seed=0)
    got = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w), 0.5, 0.25)
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32) / 8
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.LAUNCHES["qmatmul"] == 0
    with pytest.raises(ValueError, match="need x_q"):
        ops.qmatmul(torch.from_numpy(x), torch.from_numpy(x), 1.0, 1.0)


@pytest.mark.gpu
def test_cuda_qmatmul_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for M, K, N in SHAPES + [(960, 3136, 128), (8, 4096, 8)]:
        x, w = _operands(M, K, N, seed=M * N)
        if K == 4096:
            x[:], w[:] = 127, 127
        xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
        before = ops.LAUNCHES["qmatmul"]
        got = ops.qmatmul(xd, wd, 0.01, 0.02)
        assert ops.LAUNCHES["qmatmul"] == before + 1
        assert torch.equal(got, tref.qmatmul_ref(xd, wd, 0.01, 0.02)), (M, K, N)
    # contiguous slices 1 and 8 bytes past an aligned pointer: byte-wise
    # staging of a shape that is otherwise staged 16 bytes at a time
    M, K, N = 100, 3136, 128
    for offset in (0, 1, 8):
        xb = torch.randint(-128, 128, (M * K + offset,), dtype=torch.int8,
                           device=dev)
        wb = torch.randint(-128, 128, (K * N + offset,), dtype=torch.int8,
                           device=dev)
        xd, wd = xb[offset:].view(M, K), wb[offset:].view(K, N)
        assert ops.qmatmul_plan(xd, wd)[2:] == ((16, 16) if offset == 0 else (1, 1))
        assert torch.equal(ops.qmatmul(xd, wd, 0.01, 0.02),
                           tref.qmatmul_ref(xd, wd, 0.01, 0.02)), offset
    lo = torch.full((8, 4096), -128, dtype=torch.int8, device=dev)
    got = ops.qmatmul(lo, lo.t().contiguous(), 1.0, 1.0)
    assert bool((got == 128 * 128 * 4096).all())       # 67,108,864, exact
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        ops.qmatmul(xd.to(torch.int32), wd, 1.0, 1.0)
