"""The port's packed wire format against the reference's.

The plain versions of the five wire kernels (``repro_torch/kernels/ref.py``,
what a CPU tensor runs) are held bit-exact to the Pallas kernels of
``repro/kernels/pack.py`` in interpret mode, on the same numpy inputs and
the reference's own rounding noise; ``pack_codes`` / ``unpack_codes`` and
the wire plan to ``repro.core``.  Each row of a port call is one call of
the reference.  Words are compared as uint32 (the port holds them as int32
bit patterns).  The CUDA kernels are held to the plain versions by the
``gpu`` test, which needs a card.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.config.base import QuantConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import quantization as tq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

BITS = [1, 2, 4, 8]
SIZES = [1, 127, 5003]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.config.base import QuantConfig as JQuantConfig
    from repro.core import aggregation as agg
    from repro.core import quantization as quant
    from repro.kernels import pack
    from repro.kernels import ref as kref
    return types.SimpleNamespace(jax=jax, jnp=jnp, pack=pack, quant=quant,
                                 agg=agg, kref=kref, QuantConfig=JQuantConfig)


def _lanes(bits):
    """The native lane, a guard lane for a 3-4 cohort sum, the full word."""
    return sorted({bits, bits + 2, 32})


def _inputs(jx, rows, n, clip, seed):
    """x uniform over ±1.5·clip led by the boundary cases, and the
    reference's own rounding noise (``jax.random.uniform``)."""
    kx, ku = jx.jax.random.split(jx.jax.random.PRNGKey(seed))
    x = np.array(jx.jax.random.uniform(kx, (rows, n), minval=-1.5 * clip,
                                       maxval=1.5 * clip))
    edge = np.array([clip, -clip, 0.0, 2 * clip], np.float32)[:n]
    x[:, :len(edge)] = edge
    u = np.array(jx.jax.random.uniform(ku, (rows, n)))
    return x, u


def _u32(t):
    return t.numpy().view(np.uint32)


def _pallas(jx, fn, *args, **kw):
    """A Pallas kernel in interpret mode, numpy operands made jax arrays."""
    args = [jx.jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return fn(*args, interpret=True, **kw)


@pytest.mark.parametrize("bits", BITS)
def test_pack_codes_round_trip_matches_reference(jx, bits):
    """Words bit-exact with ``quantization.pack_codes`` and codes with
    ``unpack_codes``, for the default, sum_of and lane-bias variants."""
    g = 2 ** (bits - 1)
    rng = np.random.default_rng(bits)
    for n, lane in itertools.product(SIZES, _lanes(bits)):
        variants = [(1, None), (1, tq.lane_bias(lane))]
        if lane >= bits + 2:
            variants.append((3, None))            # partial sums of 3 codes
        for sum_of, bias in variants:
            codes = rng.integers(-g * sum_of, (g - 1) * sum_of + 1,
                                 (2, n)).astype(np.int32)
            want = np.stack([np.asarray(jx.quant.pack_codes(
                jx.jnp.asarray(c), bits, lane_bits=lane, sum_of=sum_of,
                bias=bias)) for c in codes])
            got = tq.pack_codes(torch.from_numpy(codes), bits, lane_bits=lane,
                                sum_of=sum_of, bias=bias)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(_u32(got), want)
            back = tq.unpack_codes(got, bits, n, lane_bits=lane,
                                   sum_of=sum_of, bias=bias)
            ref_back = np.asarray(jx.quant.unpack_codes(
                jx.jnp.asarray(want[1]), bits, n, lane_bits=lane,
                sum_of=sum_of, bias=bias))
            np.testing.assert_array_equal(back.numpy(), codes)
            np.testing.assert_array_equal(back[1].numpy(), ref_back)


@pytest.mark.parametrize("lane_kind", [0, 1, 2])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_plain_bit_exact_with_pallas(jx, bits, lane_kind):
    lanes = _lanes(bits)
    lane = lanes[min(lane_kind, len(lanes) - 1)]
    cases = [(1, 1.0, True), (127, 0.3, True), (5003, 1.0, True),
             (5003, 0.3, False)]
    for n, clip, stochastic in cases:
        x, u = _inputs(jx, 2, n, clip, seed=bits * 7 + n)
        got = ops.quantize_pack(torch.from_numpy(x), torch.from_numpy(u), bits,
                                clip=clip, lane_bits=lane,
                                stochastic=stochastic)
        for r in range(2):
            want = _pallas(jx, jx.pack.quantize_pack, x[r], u[r], bits,
                           clip=clip, lane_bits=lane, stochastic=stochastic)
            np.testing.assert_array_equal(_u32(got[r]), np.asarray(want))


@pytest.mark.parametrize("num_chunks", [1, 3, 4])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_chunk_plain_bit_exact_with_pallas(jx, bits, num_chunks):
    """Words and codes per chunk, the chunk tail a real zero code; at the
    native lane with the +G bias and at lane 32 with the lane-symmetric
    bias 2^31."""
    for n, clip, lane, bias in ((127, 1.0, bits, None),
                                (5003, 0.3, bits, None),
                                (5003, 1.0, 32, tq.lane_bias(32))):
        x, u = _inputs(jx, 2, n, clip, seed=bits + n + num_chunks)
        words, codes = ops.quantize_pack_chunk(
            torch.from_numpy(x), torch.from_numpy(u), bits, clip=clip,
            lane_bits=lane, num_chunks=num_chunks, bias=bias)
        for r in range(2):
            jw, jc = _pallas(jx, jx.pack.quantize_pack_chunk, x[r], u[r], bits,
                             clip=clip, lane_bits=lane, num_chunks=num_chunks,
                             bias=bias)
            np.testing.assert_array_equal(_u32(words[r]), np.asarray(jw))
            np.testing.assert_array_equal(codes[r].numpy(), np.asarray(jc))


def _wire_variants(bits):
    """(lane, sum_of, bias) cases: native and full-word lanes with the +G
    bias, a guard lane holding sums of 3, the lane-symmetric bias."""
    out = [(bits, 1, None), (32, 1, None), (32, 1, tq.lane_bias(32))]
    if bits + 2 < 32:
        out += [(bits + 2, 3, None), (bits + 2, 1, tq.lane_bias(bits + 2))]
    return out


def _words(rng, bits, lane, sum_of, bias, rows, n):
    g = 2 ** (bits - 1)
    codes = rng.integers(-g * sum_of, (g - 1) * sum_of + 1, (rows, n))
    return tq.pack_codes(torch.from_numpy(codes.astype(np.int32)), bits,
                         lane_bits=lane, sum_of=sum_of, bias=bias)


@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequantize_plain_bit_exact_with_pallas(jx, bits):
    rng = np.random.default_rng(bits)
    for (lane, sum_of, bias), n, clip in itertools.product(
            _wire_variants(bits), (127, 5003), (1.0, 0.3)):
        words = _words(rng, bits, lane, sum_of, bias, 1, n)
        got = ops.unpack_dequantize(words[0], bits, n, clip=clip,
                                    lane_bits=lane, sum_of=sum_of, bias=bias)
        want = _pallas(jx, jx.pack.unpack_dequantize, _u32(words[0]), bits, n,
                       clip=clip, lane_bits=lane, sum_of=sum_of, bias=bias)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", BITS)
def test_repack_plain_bit_exact_with_pallas(jx, bits):
    """Row r of acc takes the words of row (r - hop) mod R, as the Pallas
    repack takes the words one ppermute delivered; acc is updated in place."""
    rng = np.random.default_rng(10 + bits)
    R = 3
    for (lane, sum_of, bias), n, hop in itertools.product(
            _wire_variants(bits), (1, 5003), (0, 1, 5)):
        words = _words(rng, bits, lane, sum_of, bias, R, n)
        acc0 = rng.integers(-1000, 1000, (R, n)).astype(np.int32)
        acc = torch.from_numpy(acc0.copy())
        out = ops.repack(words, acc, bits, n, hop=hop, lane_bits=lane,
                         sum_of=sum_of, bias=bias)
        assert out is acc
        for r in (0, 2):
            want = _pallas(jx, jx.pack.repack, _u32(words[(r - hop) % R]),
                           acc0[r], bits, n, lane_bits=lane, sum_of=sum_of,
                           bias=bias)
            np.testing.assert_array_equal(acc[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", BITS)
def test_pack_sums_plain_bit_exact_with_pallas(jx, bits):
    """Partial sums packed at lanes {bits, bits+2, 32} with the sum_of·G
    bias (sums of 1 and, where the lane has room, of 3 codes) and with the
    explicit lane-symmetric bias, at odd sizes and R in {1, 3} rows, each
    row one call of the Pallas kernel."""
    g = 2 ** (bits - 1)
    rng = np.random.default_rng(30 + bits)
    for lane, (n, R) in itertools.product(_lanes(bits), ((127, 1), (5003, 3))):
        variants = [(1, None), (1, tq.lane_bias(lane))]
        if lane >= bits + 2:
            variants.append((3, None))
        for sum_of, bias in variants:
            codes = rng.integers(-g * sum_of, (g - 1) * sum_of + 1,
                                 (R, n)).astype(np.int32)
            got = ops.pack_sums(torch.from_numpy(codes), bits, lane_bits=lane,
                                sum_of=sum_of, bias=bias)
            assert got.dtype == torch.int32
            assert got.shape == (R, tq.packed_words(n, bits, lane_bits=lane))
            for r in range(R):
                want = _pallas(jx, jx.pack.pack_sums, codes[r], bits,
                               lane_bits=lane, sum_of=sum_of, bias=bias)
                np.testing.assert_array_equal(
                    _u32(got[r]), np.asarray(want),
                    err_msg=f"lane={lane} n={n} sum_of={sum_of} bias={bias}")


@pytest.mark.parametrize("grid", [(2, 3), (3, 2)], ids=str)
def test_axis_repack_reads_the_row_one_axis_hop_back(jx, grid):
    """On a (P, K) cohort grid stacked row-major (row p·K + d), a hop of h
    along the outer axis (P entries, K rows a step) or the inner one (K
    entries, one row a step) adds into row r the words of the row h steps
    back on that axis; each row equals the reference's ``repack_ref``
    applied to that source row."""
    P, K = grid
    R, n, bits = P * K, 1001, 8
    rng = np.random.default_rng(P * 10 + K)
    for lane, sum_of, bias in _wire_variants(bits)[:2] + [(10, 1, 512)]:
        words = _words(rng, bits, lane, sum_of, bias, R, n)
        acc0 = rng.integers(-1000, 1000, (R, n)).astype(np.int32)
        for (axis, inner), hop in itertools.product(((P, K), (K, 1)),
                                                    range(4)):
            acc = torch.from_numpy(acc0.copy())
            out = ops.repack(words, acc, bits, n, hop=hop, lane_bits=lane,
                             sum_of=sum_of, bias=bias, axis_size=axis,
                             inner=inner)
            assert out is acc
            for r in range(R):
                p, d = divmod(r, K)
                src = (((p - hop) % P) * K + d if inner == K
                       else p * K + (d - hop) % K)
                want = jx.kref.repack_ref(
                    jx.jnp.asarray(_u32(words[src])), jx.jnp.asarray(acc0[r]),
                    bits, n, lane_bits=lane, sum_of=sum_of, bias=bias)
                np.testing.assert_array_equal(
                    acc[r].numpy(), np.asarray(want),
                    err_msg=f"axis={axis} inner={inner} hop={hop} row={r}")
    with pytest.raises(ValueError, match="stack"):
        ops.repack(words, acc, bits, n, hop=1, lane_bits=lane,
                   axis_size=4, inner=1)


@pytest.mark.parametrize("lane", [1, 2, 3, 4, 5, 6, 8, 10, 16, 32])
def test_consecutive_repack_hops_match_the_reference(jx, lane):
    """The ring's in-place pattern, at one lane of each codes-per-word count
    (32, 16, 10, 8, 6, 5, 4, 3, 2, 1 codes a word): hops 1..R-1 into one
    acc, each row equal to the reference's ``repack_ref`` applied hop by
    hop to that row; every row ends holding the sum over the rows."""
    bits = min(lane, 8)
    R, n = 4, 1001
    rng = np.random.default_rng(lane)
    words = _words(rng, bits, lane, 1, None, R, n)
    codes = tq.unpack_codes(words, bits, n, lane_bits=lane)
    acc = codes.clone()
    want = [jx.jnp.asarray(codes[r].numpy()) for r in range(R)]
    for hop in range(1, R):
        ops.repack(words, acc, bits, n, hop=hop, lane_bits=lane)
        for r in range(R):
            want[r] = jx.kref.repack_ref(jx.jnp.asarray(_u32(words[(r - hop) % R])),
                                         want[r], bits, n, lane_bits=lane)
    for r in range(R):
        np.testing.assert_array_equal(acc[r].numpy(), np.asarray(want[r]))
    assert torch.equal(acc, codes.sum(0, dtype=torch.int32).expand(R, n))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.linspace(-1.2, 1.2, 101).reshape(1, -1)
    u = torch.full_like(x, 0.5)
    words = ops.quantize_pack(x, u, 8)
    torch.testing.assert_close(words, tref.quantize_pack_ref(x, u, 8),
                               rtol=0, atol=0)
    ops.unpack_dequantize(words, 8, 101)
    w2, c2 = ops.quantize_pack_chunk(x, u, 8, num_chunks=1)
    assert torch.equal(w2[:, 0], words)
    ops.repack(words, c2[:, 0].clone(), 8, 101)
    sums = ops.pack_sums(c2[:, 0].contiguous(), 8)
    assert torch.equal(sums, words)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_wire_wrappers_reject_bad_arguments():
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="32-bit"):
        ops.quantize_pack(x, x, 8, lane_bits=33)
    with pytest.raises(ValueError, match="u of x's shape"):
        ops.quantize_pack(x, None, 8)
    with pytest.raises(ValueError, match="uint32"):
        ops.unpack_dequantize(torch.zeros(3, dtype=torch.int32), 8, 12,
                              bias=2 ** 32)
    with pytest.raises(ValueError, match="does not fit"):
        ops.unpack_dequantize(torch.zeros(3, dtype=torch.int32), 8, 13)
    with pytest.raises(ValueError, match="acc"):
        ops.repack(torch.zeros(2, 3, dtype=torch.int32),
                   torch.zeros(3, 12, dtype=torch.int32), 8, 12)
    with pytest.raises(ValueError, match="num_chunks"):
        ops.quantize_pack_chunk(x, x, 8, num_chunks=0)


# -- the wire plan: pure Python, equal to the reference's --------------------

PLAN_BITS = [0, 1, 2, 4, 8, 16, 30]
PLAN_SIZES = [(2,), (3,), (4,), (8,), (10,), (16,), (32,), (2, 4), (4, 16),
              (2, 2, 2)]


@pytest.mark.parametrize("uplink", [True, False])
@pytest.mark.parametrize("bits", PLAN_BITS)
def test_wire_plan_equals_the_reference(jx, bits, uplink):
    """``make_wire_plan``, ``resolve_auto``, ``effective_wire_format`` and
    ``wire_phase_bits_per_param`` return the reference's values exactly for
    every mode and cohort layout of ``tests/test_aggregation.py`` (and
    more)."""
    q = QuantConfig(bits=bits, quantize_uplink=uplink)
    jq = jx.QuantConfig(bits=bits, quantize_uplink=uplink)
    for sizes in PLAN_SIZES:
        axes = ("pod", "data", "x")[-len(sizes):]
        n = int(np.prod(sizes))
        assert tagg.resolve_auto(q, sizes) == jx.agg.resolve_auto(jq, sizes)
        for mode in ("paper", "int", "packed", "ring", "rsag", "auto"):
            got = tagg.make_wire_plan(mode, q, axes, sizes)
            want = jx.agg.make_wire_plan(mode, jq, axes, sizes)
            assert (got.mode, got.resolved, got.effective, got.axes,
                    got.axis_sizes, got.num_shards, got.wire_bits) == \
                (want.mode, want.resolved, want.effective, want.axes,
                 want.axis_sizes, want.num_shards, want.wire_bits)
            assert tagg.wire_phase_bits_per_param(mode, q, sizes) == \
                jx.agg.wire_phase_bits_per_param(mode, jq, sizes)
            assert tagg.effective_wire_format(mode, q, n) == \
                jx.agg.effective_wire_format(mode, jq, n)
    with pytest.raises(ValueError):
        tagg.make_wire_plan("bogus", q, ("data",), (2,))


def test_int_container_and_payload_counts_equal_the_reference(jx):
    names = {torch.int8: "int8", torch.int16: "int16", torch.int32: "int32"}
    for bits, shards in itertools.product([1, 2, 4, 8, 16], [1, 2, 3, 16, 512]):
        assert names[tagg._int_container(bits, shards)] == \
            jx.jnp.dtype(jx.agg._int_container(bits, shards)).name
        assert tq.packed_lane_bits(bits, shards) == \
            jx.quant.packed_lane_bits(bits, shards)
    for n, bits, sizes in itertools.product([1, 5003, 421_642], [1, 2, 8, 16],
                                            [(2,), (10,), (2, 4), (16,)]):
        assert tq.packed_payload_bits(n, bits, num_shards=int(np.prod(sizes))) \
            == jx.quant.packed_payload_bits(n, bits,
                                            num_shards=int(np.prod(sizes)))
        assert tq.ring_payload_bits(n, bits, sizes) == \
            jx.quant.ring_payload_bits(n, bits, sizes)
        assert tq.rsag_payload_bits(n, bits, sizes) == \
            jx.quant.rsag_payload_bits(n, bits, sizes)
    assert tq.lane_bias(32) == jx.quant.lane_bias(32) == 2 ** 31


@pytest.mark.gpu
def test_cuda_pack_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for (R, n), bits, clip in itertools.product(((10, 421_642), (3, 5003),
                                                 (1, 7)), BITS, (1.0, 0.3)):
        x = (torch.rand((R, n), generator=gen, device=dev) - 0.5) * 3 * clip
        u = torch.rand((R, n), generator=gen, device=dev)
        for lane in _lanes(bits):
            words = ops.quantize_pack(x, u, bits, clip=clip, lane_bits=lane)
            assert torch.equal(words, tref.quantize_pack_ref(
                x, u, bits, clip=clip, lane_bits=lane))
            for k in (1, 3):
                got = ops.quantize_pack_chunk(x, u, bits, clip=clip,
                                              lane_bits=lane, num_chunks=k)
                want = tref.quantize_pack_chunk_ref(x, u, bits, clip=clip,
                                                    lane_bits=lane,
                                                    num_chunks=k)
                assert all(map(torch.equal, got, want))
        for lane, sum_of, bias in _wire_variants(bits):
            codes = torch.randint(-2 ** (bits - 1), 2 ** (bits - 1), (R, n),
                                  generator=gen, device=dev, dtype=torch.int32)
            words = tq.pack_codes(codes, bits, lane_bits=lane, bias=bias)
            assert torch.equal(
                ops.unpack_dequantize(words, bits, n, clip=clip,
                                      lane_bits=lane, bias=bias),
                tref.unpack_dequantize_ref(words, bits, n, clip=clip,
                                           lane_bits=lane, bias=bias))
            acc = codes.clone()
            want = tref.repack_ref(words, codes.clone(), bits, n, hop=1,
                                   lane_bits=lane, bias=bias)
            assert torch.equal(ops.repack(words, acc, bits, n, hop=1,
                                          lane_bits=lane, bias=bias), want)
            assert torch.equal(
                ops.pack_sums(codes, bits, lane_bits=lane, bias=bias), words)
        if R == 10:                      # the (2, 5) grid, along each axis
            for axis, inner in ((2, 5), (5, 1)):
                acc = codes.clone()
                want = tref.repack_ref(words, codes.clone(), bits, n, hop=1,
                                       lane_bits=lane, bias=bias,
                                       axis_size=axis, inner=inner)
                assert torch.equal(ops.repack(
                    words, acc, bits, n, hop=1, lane_bits=lane, bias=bias,
                    axis_size=axis, inner=inner), want)
        if R == 10:                      # the ring's hops, in place
            words = tq.pack_codes(codes, bits)
            acc, want = codes.clone(), codes.clone()
            for hop in range(1, R):
                ops.repack(words, acc, bits, n, hop=hop)
                tref.repack_ref(words, want, bits, n, hop=hop)
            assert torch.equal(acc, want)
        sums = torch.randint(-3 * 2 ** (bits - 1), 3 * 2 ** (bits - 1), (R, n),
                             generator=gen, device=dev, dtype=torch.int32)
        for lane in (bits + 2, 32):
            assert torch.equal(
                ops.pack_sums(sums, bits, lane_bits=lane, sum_of=3),
                tref.pack_sums_ref(sums, bits, lane_bits=lane, sum_of=3))
    # every lane, so every codes-per-word specialisation of repack,
    # pack_sums and unpack_dequantize
    for lane in range(1, 33):
        bits = min(lane, 8)
        codes = torch.randint(-2 ** (bits - 1), 2 ** (bits - 1), (3, 5003),
                              generator=gen, device=dev, dtype=torch.int32)
        words = tq.pack_codes(codes, bits, lane_bits=lane)
        acc = codes.clone()
        assert torch.equal(
            ops.repack(words, acc, bits, 5003, hop=2, lane_bits=lane),
            tref.repack_ref(words, codes.clone(), bits, 5003, hop=2,
                            lane_bits=lane)), lane
        assert torch.equal(ops.pack_sums(codes, bits, lane_bits=lane),
                           words), lane
        assert torch.equal(
            ops.unpack_dequantize(words, bits, 5003, clip=0.3, lane_bits=lane),
            tref.unpack_dequantize_ref(words, bits, 5003, clip=0.3,
                                       lane_bits=lane)), lane
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_pack_sums_and_unpack_at_tile_edges():
    """pack_sums and unpack_dequantize on 1 and 10 rows of W words one
    below, at and one above a tile of their launch plan (256 threads times
    the words a thread owns), with n = cpw·W and the least n of W words; and at lane 32
    with the lane-symmetric bias 2^31."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for lane, rows in itertools.product((9, 12, 5, 32), (1, 10)):
        bits, cpw = min(lane, 8), 32 // lane
        bias = tq.lane_bias(lane)
        lo, hi = (-2 ** 30, 2 ** 30) if lane == 32 else (
            -2 ** (lane - 1), 2 ** (lane - 1))
        probe = torch.zeros((rows, cpw), dtype=torch.int32, device=dev)
        for kind in ("pack_sums", "unpack_dequantize"):
            plan = (ops.pack_sums_plan(probe, bits, lane_bits=lane)
                    if kind == "pack_sums" else
                    ops.unpack_dequantize_plan(probe, bits, lane_bits=lane))
            assert plan.cpw == cpw and plan.tiles == rows
            tile = 256 * plan.words
            for W in (tile - 1, tile, tile + 1):
                for n in {cpw * W, cpw * (W - 1) + 1}:
                    sums = torch.randint(lo, hi, (rows, n), generator=gen,
                                         device=dev, dtype=torch.int32)
                    words = ops.pack_sums(sums, bits, lane_bits=lane,
                                          bias=bias)
                    want = tref.pack_sums_ref(sums, bits, lane_bits=lane,
                                              bias=bias)
                    assert words.shape == (rows, W)
                    assert torch.equal(words, want), (kind, lane, rows, n)
                    assert torch.equal(
                        ops.unpack_dequantize(words, bits, n, lane_bits=lane,
                                              bias=bias),
                        tref.unpack_dequantize_ref(want, bits, n,
                                                   lane_bits=lane, bias=bias)
                    ), (kind, lane, rows, n)
    torch.cuda.synchronize()
