"""The port's quantizer at clips other than 1, against the reference.

The reference scales by a multiply, ``clip(x, -clip, clip)·float32(G/clip)``
(``repro/kernels/ref.py`` ``stochastic_quantize_ref``, the default round
path ``repro/core/quantization.py`` ``quantize_codes``); under jit its
Pallas kernels get ``x·float32(1/clip)`` times the power of two G, the
same product.  At 16 and 24 bits a step is a few ulp of the scaled value,
so any other rounding of the scale (a division by the clip, or a scale
rounded twice) moves codes by one.  Here the port's plain versions (what
a CPU tensor runs, and what ``chip_smoke.py`` holds the CUDA kernels to)
are held bit-exact to the eager oracle on 10^5 values at 16 and 24 bits
and to the Pallas kernels in interpret mode on a few thousand, at every
bits x clip case, both roundings, led by the quantizer's edge values.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

BITS = [1, 2, 4, 8, 12, 16, 24]
CLIPS = [1.0, 0.3, 0.7, 2.5]
PALLAS_N = 3001          # values held to the Pallas kernels, odd


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import pack
    from repro.kernels import ref
    from repro.kernels.quantize import stochastic_quantize_codes
    return types.SimpleNamespace(jnp=jnp, ref=ref, pack=pack,
                                 quantize=stochastic_quantize_codes)


def _inputs(n, clip, bits, seed):
    """x uniform over ±1.3·clip, u uniform over [0, 1), led by the edges:
    ±clip and their float32 neighbours, ±2·clip, 0, half and 1.5 steps,
    with u at 0, 0.5 and just below 1."""
    rng = np.random.default_rng(seed)
    step = clip / 2 ** (bits - 1)
    c = np.float32(clip)
    x = rng.uniform(-1.3 * clip, 1.3 * clip, n).astype(np.float32)
    edge = np.array([c, -c, np.nextafter(c, np.float32(0)),
                     -np.nextafter(c, np.float32(0)), np.nextafter(c, 2 * c),
                     2 * clip, -2 * clip, 0.0, 0.5 * step, -0.5 * step,
                     1.5 * step, -2.5 * step], np.float32)
    x[:len(edge)] = edge
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:3] = [0.0, 0.5, np.nextafter(np.float32(1), np.float32(0))]
    u[len(edge):len(edge) + 3] = u[:3]
    return x, u


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("bits", BITS)
def test_plain_quantizer_equals_eager_oracle_and_pallas(jx, bits, clip,
                                                        stochastic):
    n = 100_000 if bits >= 16 else 5_000
    x, u = _inputs(n, clip, bits, seed=bits * 1000 + int(clip * 10))
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    got = tref.stochastic_quantize_ref(xt, ut if stochastic else None, bits,
                                       clip=clip, stochastic=stochastic)
    assert got.dtype == torch.int32
    oracle = np.asarray(jx.ref.stochastic_quantize_ref(
        jx.jnp.asarray(x), jx.jnp.asarray(u), bits, clip=clip,
        stochastic=stochastic))
    np.testing.assert_array_equal(got.numpy(), oracle)
    pallas = np.asarray(jx.quantize(
        jx.jnp.asarray(x[:PALLAS_N]), jx.jnp.asarray(u[:PALLAS_N]), bits,
        clip=clip, stochastic=stochastic, interpret=True))
    np.testing.assert_array_equal(got[:PALLAS_N].numpy(), pallas)
    # a CPU tensor takes the plain version through the wrapper
    assert torch.equal(ops.stochastic_quantize_codes(
        xt, ut if stochastic else None, bits, clip=clip,
        stochastic=stochastic), got)


@pytest.mark.parametrize("lane", [24, 28])
@pytest.mark.parametrize("clip", [0.3, 2.5])
@pytest.mark.parametrize("bits", [12, 16, 24])
def test_plain_wire_quantizers_equal_pallas(jx, bits, clip, lane):
    """quantize_pack and quantize_pack_chunk (3 chunks, the last one
    padded) on two rows of an odd n: words as uint32 and codes bit-exact
    with the Pallas kernels, codes with the eager oracle."""
    rows, n, k = 2, PALLAS_N, 3
    x, u = _inputs(rows * n, clip, bits, seed=bits * 100 + lane)
    x, u = x.reshape(rows, n), u.reshape(rows, n)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    words = tref.quantize_pack_ref(xt, ut, bits, clip=clip, lane_bits=lane)
    for r in range(rows):
        want = jx.pack.quantize_pack(
            jx.jnp.asarray(x[r]), jx.jnp.asarray(u[r]), bits, clip=clip,
            lane_bits=lane, interpret=True)
        np.testing.assert_array_equal(words[r].numpy().view(np.uint32),
                                      np.asarray(want))
    words, codes = tref.quantize_pack_chunk_ref(xt, ut, bits, clip=clip,
                                                lane_bits=lane, num_chunks=k)
    C = -(-n // k)
    for r in range(rows):
        jw, jc = jx.pack.quantize_pack_chunk(
            jx.jnp.asarray(x[r]), jx.jnp.asarray(u[r]), bits, clip=clip,
            lane_bits=lane, num_chunks=k, interpret=True)
        np.testing.assert_array_equal(words[r].numpy().view(np.uint32),
                                      np.asarray(jw))
        np.testing.assert_array_equal(codes[r].numpy(), np.asarray(jc))
        oracle = np.asarray(jx.ref.stochastic_quantize_ref(
            jx.jnp.asarray(x[r]), jx.jnp.asarray(u[r]), bits, clip=clip))
        np.testing.assert_array_equal(codes[r].reshape(-1)[:n].numpy(), oracle)
        assert not codes[r].reshape(-1)[n:].any() and k * C > n
