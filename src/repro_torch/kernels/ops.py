"""Kernel wrappers: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
its plain version in ``ref.py``.  A tensor anywhere else raises.

Each wrapper checks device, dtype, contiguity and shape, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch reports an error.  ``LAUNCHES``
counts kernel launches per wrapper (never plain-version calls), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantization as wire
from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"stochastic_quantize_codes": 0,
                            "dequantize_codes": 0, "masked_aggregate": 0,
                            "masked_aggregate_den": 0,
                            "quantize_pack": 0, "unpack_dequantize": 0,
                            "quantize_pack_chunk": 0, "repack": 0,
                            "pack_sums": 0, "qmatmul": 0, "fma_step": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def _check(t: torch.Tensor, dtype: torch.dtype, device: torch.device,
           what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 24:
        raise ValueError(f"bits must be in [1, 24], got {bits}")


def _inv_gain(bits: int, clip: float) -> float:
    return float(np.float32(clip / float(2 ** (bits - 1))))


def _wire_args(bits: int, lane_bits: int, sum_of: int,
               bias: Optional[int]) -> Tuple[int, int, int]:
    """(lane, cpw, bias) of a packed buffer; raises on a lane over 32 bits
    or a bias outside uint32."""
    _check_bits(bits)
    lane = lane_bits or bits
    cpw = wire.codes_per_word(bits, lane_bits=lane)
    b = int(2 ** (bits - 1)) * int(sum_of) if bias is None else int(bias)
    if not 0 <= b < 2 ** 32:
        raise ValueError(f"bias {b} is outside uint32")
    return lane, cpw, b


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (R, n), got {tuple(x.shape)}")


def _check_noise(x: torch.Tensor, u: Optional[torch.Tensor],
                 stochastic: bool) -> None:
    if stochastic and (u is None or u.shape != x.shape):
        raise ValueError("stochastic quantization needs u of x's shape")


def _empty_at_offset_of(like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised tensor of ``like``'s shape (4-byte ``dtype``) that
    starts the same number of bytes past a 16-byte boundary as ``like``:
    a view into a buffer 1-3 elements longer where that is not 0.  The
    quantizer's kernels take their 16-byte path only where every pointer
    shares one offset, so a view of x that is not aligned keeps it."""
    k = like.data_ptr() % 16 // 4
    if k == 0:
        return torch.empty(like.shape, dtype=dtype, device=like.device)
    buf = torch.empty(like.numel() + k, dtype=dtype, device=like.device)
    return buf[k:].view(like.shape)


class QuantizerPlan(NamedTuple):
    vector: bool    # the 16-byte path: every pointer at one offset past a
                    # 16-byte boundary; else one scalar loop
    head: int       # elements before the first boundary, one a thread
    vectors: int    # 16-byte vectors of 4 elements
    tail: int       # elements after the last vector, one a thread


def quantizer_plan(src: torch.Tensor, noise: Optional[torch.Tensor],
                   out: torch.Tensor) -> QuantizerPlan:
    """The path the quantizer's kernels take for these CUDA tensors of one
    size, as their C side picks it from the pointers:
    ``stochastic_quantize_codes`` reads x and u and writes codes,
    ``dequantize_codes`` reads codes (``noise`` None) and writes out;
    nearest rounding reads no noise either."""
    counts = (ctypes.c_longlong * 3)()
    vector = build.library("quantize").repro_quantizer_plan(
        src.data_ptr(), None if noise is None else noise.data_ptr(),
        out.data_ptr(), src.numel(), counts)
    return QuantizerPlan(bool(vector), *counts)


def stochastic_quantize_codes(x: torch.Tensor, u: Optional[torch.Tensor],
                              bits: int, *, clip: float = 1.0,
                              stochastic: bool = True) -> torch.Tensor:
    """f32 ``x`` and noise ``u`` (same shape) -> int32 codes in [-G, G-1].

    ``u`` is read only when ``stochastic``; nearest rounding may pass None.
    On the card the codes start at x's offset past a 16-byte boundary.
    """
    _check_bits(bits)
    _check_noise(x, u, stochastic)
    if not _on_cuda(x, "x"):
        return ref.stochastic_quantize_ref(x, u, bits, clip=clip,
                                           stochastic=stochastic)
    _check(x, torch.float32, x.device, "x")
    if stochastic:
        _check(u, torch.float32, x.device, "u")
    codes = _empty_at_offset_of(x, torch.int32)
    err = build.library("quantize").repro_quantize_codes(
        x.data_ptr(), u.data_ptr() if stochastic else None, codes.data_ptr(),
        x.numel(), *ref.quant_step(bits, clip), bits, int(stochastic),
        _stream(x.device))
    _raise_on(err, "stochastic_quantize_codes")
    LAUNCHES["stochastic_quantize_codes"] += 1
    return codes


def dequantize_codes(codes: torch.Tensor, bits: int, *,
                     clip: float = 1.0) -> torch.Tensor:
    """int32 codes -> f32 ``codes · float32(clip/G)``; on the card the
    output starts at the codes' offset past a 16-byte boundary."""
    _check_bits(bits)
    if not _on_cuda(codes, "codes"):
        return ref.dequantize_ref(codes, bits, clip=clip)
    _check(codes, torch.int32, codes.device, "codes")
    out = _empty_at_offset_of(codes, torch.float32)
    err = build.library("quantize").repro_dequantize_codes(
        codes.data_ptr(), out.data_ptr(), codes.numel(), _inv_gain(bits, clip),
        _stream(codes.device))
    _raise_on(err, "dequantize_codes")
    LAUNCHES["dequantize_codes"] += 1
    return out


class AggregatePlan(NamedTuple):
    k_spec: int      # the K specialisation (1-16), 0 for the generic kernel
    load_bytes: int  # bytes a load of the updates: 16, 8 or 4
    loads: int       # loads a thread issues before its first FMA
    head: int        # columns before the first boundary, one a thread
    vectors: int     # whole vectors of load_bytes / 4 columns
    tail: int        # columns after the last vector, one a thread
    tiles: int       # tiles of 256 threads' vectors
    blocks: int      # blocks launched: one wave, capped by the tiles


def _aggregate_out(updates: torch.Tensor) -> torch.Tensor:
    """The (D,) output, at the updates' offset past a 16-byte boundary:
    the kernel's vector path needs every row start and the output there."""
    return _empty_at_offset_of(updates[0], torch.float32)


def masked_aggregate_plan(updates: torch.Tensor) -> AggregatePlan:
    """The launch ``masked_aggregate`` makes for CUDA updates (K, D), as the
    kernel's C side picks it from K, D, the pointers (the output's offset
    is the updates') and the card's SM count."""
    K, D = updates.shape
    out = _aggregate_out(updates)
    plan = (ctypes.c_longlong * 8)()
    build.library("aggregate").repro_masked_aggregate_plan(
        updates.data_ptr(), out.data_ptr(), K, D,
        int(updates.dtype == torch.int32), plan)
    return AggregatePlan(*plan)


def masked_aggregate(updates: torch.Tensor, weights: torch.Tensor,
                     eps: float = 1e-12, *,
                     den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """updates (K, D) f32/int32, weights (K,) f32 -> (D,) f32 (paper eq. 6):
    ``fma(w_k, u_k, acc)`` over k in order, over the weights' sum in order
    (the reference's order).  ``den``, a 0-dim float32 tensor on the
    updates' device, replaces max(Σ w_k, eps) as the divisor; the kernel
    reads it on the device (no host sync), and its launches count as
    ``masked_aggregate_den``.  On the card the output starts at the
    updates' offset past a 16-byte boundary."""
    if updates.dim() != 2 or weights.shape != (updates.shape[0],):
        raise ValueError(f"need updates (K, D) and weights (K,), got "
                         f"{tuple(updates.shape)} and {tuple(weights.shape)}")
    if updates.shape[0] < 1:
        raise ValueError("masked_aggregate needs K >= 1")
    if den is not None and den.shape != ():
        raise ValueError(f"den must be 0-dim, got {tuple(den.shape)}")
    if not _on_cuda(updates, "updates"):
        return ref.masked_aggregate_ref(updates, weights, eps, den=den)
    if updates.dtype == torch.float32:
        fn = "repro_masked_aggregate_f32"
    elif updates.dtype == torch.int32:
        fn = "repro_masked_aggregate_i32"
    else:
        raise TypeError(f"updates must be float32 or int32, got {updates.dtype}")
    _check(updates, updates.dtype, updates.device, "updates")
    _check(weights, torch.float32, updates.device, "weights")
    if den is not None:
        _check(den, torch.float32, updates.device, "den")
    K, D = updates.shape
    out = _aggregate_out(updates)
    err = getattr(build.library("aggregate"), fn)(
        updates.data_ptr(), weights.data_ptr(),
        den.data_ptr() if den is not None else None, out.data_ptr(), K, D,
        float(np.float32(eps)), _stream(updates.device))
    _raise_on(err, "masked_aggregate")
    LAUNCHES["masked_aggregate" if den is None else "masked_aggregate_den"] += 1
    return out


class PackPlan(NamedTuple):
    cpw: int        # codes per word: the kernel's specialisation
    words: int      # words a thread owns, all their loads issued first
    load_bytes: int  # bytes a load of the kernel's input
    tiles: int      # tiles of 256 * words words, each within one row (chunk)
    blocks: int     # blocks launched: one wave of resident blocks, capped
                    # by the tiles


#: the kernels ``repro_pack_plan`` reports on, by its code
_PLANNED = {"quantize_pack": 0, "quantize_pack_chunk": 1, "pack_sums": 2,
            "unpack_dequantize": 3}


def _plan(kernel: str, stochastic: bool, segments: int, W: int,
          lane: int) -> PackPlan:
    out = (ctypes.c_longlong * 5)()
    err = build.library("pack").repro_pack_plan(
        _PLANNED[kernel], int(stochastic), segments, W, lane, out)
    _raise_on(err, f"{kernel} plan")
    return PackPlan(*out)


def pack_plan(x: torch.Tensor, bits: int, *, lane_bits: int = 0,
              stochastic: bool = True, num_chunks: int = 0) -> PackPlan:
    """The launch ``quantize_pack`` (``num_chunks`` 0) or
    ``quantize_pack_chunk`` makes for a CUDA x (R, n), as the kernels' C
    side picks it from the lane and the card's SM count."""
    lane, _, _ = _wire_args(bits, lane_bits, 1, None)
    _check_rows(x)
    R, n = x.shape
    k = max(int(num_chunks), 1)
    W = wire.packed_words(-(-n // k), bits, lane_bits=lane)
    return _plan("quantize_pack_chunk" if num_chunks > 0 else "quantize_pack",
                 stochastic, R * k, W, lane)


def pack_sums_plan(codes: torch.Tensor, bits: int, *,
                   lane_bits: int = 0) -> PackPlan:
    """The launch ``pack_sums`` makes for CUDA partial sums (R, n)."""
    lane, _, _ = _wire_args(bits, lane_bits, 1, None)
    _check_rows(codes)
    R, n = codes.shape
    return _plan("pack_sums", False, R,
                 wire.packed_words(n, bits, lane_bits=lane), lane)


def unpack_dequantize_plan(packed: torch.Tensor, bits: int, *,
                           lane_bits: int = 0) -> PackPlan:
    """The launch ``unpack_dequantize`` makes for CUDA words (R, W) or
    (W,)."""
    lane, _, _ = _wire_args(bits, lane_bits, 1, None)
    p2 = packed.reshape(-1, packed.shape[-1])
    return _plan("unpack_dequantize", False, p2.shape[0], p2.shape[1], lane)


def quantize_pack(x: torch.Tensor, u: Optional[torch.Tensor], bits: int, *,
                  clip: float = 1.0, lane_bits: int = 0,
                  stochastic: bool = True) -> torch.Tensor:
    """f32 x (R, n) with noise u -> words (R, ceil(n/cpw)), int32 tensors
    holding the uint32 pattern: quantize, bias +G and pack planar at
    ``lane_bits`` (default ``bits``)."""
    lane, cpw, _ = _wire_args(bits, lane_bits, 1, None)
    _check_rows(x)
    _check_noise(x, u, stochastic)
    if not _on_cuda(x, "x"):
        return ref.quantize_pack_ref(x, u, bits, clip=clip, lane_bits=lane,
                                     stochastic=stochastic)
    _check(x, torch.float32, x.device, "x")
    if stochastic:
        _check(u, torch.float32, x.device, "u")
    R, n = x.shape
    W = wire.packed_words(n, bits, lane_bits=lane)
    words = torch.empty((R, W), dtype=torch.int32, device=x.device)
    err = build.library("pack").repro_quantize_pack(
        x.data_ptr(), u.data_ptr() if stochastic else None, words.data_ptr(),
        R, n, W, lane, *ref.quant_step(bits, clip), bits, int(stochastic),
        _stream(x.device))
    _raise_on(err, "quantize_pack")
    LAUNCHES["quantize_pack"] += 1
    return words


def unpack_dequantize(packed: torch.Tensor, bits: int, size: int, *,
                      clip: float = 1.0, lane_bits: int = 0, sum_of: int = 1,
                      bias: Optional[int] = None) -> torch.Tensor:
    """words (R, W) or (W,) -> f32 (R, size) or (size,): extract each lane,
    un-bias by sum_of·G (or ``bias``) modulo 2^32, times float32(clip/G)."""
    lane, cpw, b = _wire_args(bits, lane_bits, sum_of, bias)
    if not 0 <= size <= cpw * packed.shape[-1]:
        raise ValueError(f"size {size} does not fit {packed.shape[-1]} words "
                         f"of {cpw} codes")
    if packed.dim() not in (1, 2):
        raise ValueError(f"packed must be (W,) or (R, W), got "
                         f"{tuple(packed.shape)}")
    if not _on_cuda(packed, "packed"):
        return ref.unpack_dequantize_ref(packed, bits, size, clip=clip,
                                         lane_bits=lane, sum_of=sum_of,
                                         bias=bias)
    p2 = packed.reshape(-1, packed.shape[-1])
    _check(p2, torch.int32, packed.device, "packed")
    R, W = p2.shape
    out = torch.empty((R, size), dtype=torch.float32, device=packed.device)
    err = build.library("pack").repro_unpack_dequantize(
        p2.data_ptr(), out.data_ptr(), R, size, W, lane, b,
        _inv_gain(bits, clip), _stream(packed.device))
    _raise_on(err, "unpack_dequantize")
    LAUNCHES["unpack_dequantize"] += 1
    return out.reshape(size) if packed.dim() == 1 else out


def quantize_pack_chunk(x: torch.Tensor, u: Optional[torch.Tensor], bits: int,
                        *, clip: float = 1.0, lane_bits: int = 0,
                        stochastic: bool = True, num_chunks: int = 1,
                        bias: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 x (R, n) with noise u -> (words (R, k, Wc), codes (R, k, C)),
    k = ``num_chunks``, C = ceil(n/k), Wc = ceil(C/cpw): quantize once and
    emit each chunk's packed words and its int32 codes.  The chunk tail is
    the real zero code (biased on the wire); word padding is raw 0."""
    lane, cpw, b = _wire_args(bits, lane_bits, 1, bias)
    _check_rows(x)
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    _check_noise(x, u, stochastic)
    if not _on_cuda(x, "x"):
        return ref.quantize_pack_chunk_ref(x, u, bits, clip=clip,
                                           lane_bits=lane,
                                           stochastic=stochastic,
                                           num_chunks=num_chunks, bias=bias)
    _check(x, torch.float32, x.device, "x")
    if stochastic:
        _check(u, torch.float32, x.device, "u")
    R, n = x.shape
    k = int(num_chunks)
    C = -(-n // k)
    Wc = wire.packed_words(C, bits, lane_bits=lane)
    words = torch.empty((R, k, Wc), dtype=torch.int32, device=x.device)
    codes = torch.empty((R, k, C), dtype=torch.int32, device=x.device)
    err = build.library("pack").repro_quantize_pack_chunk(
        x.data_ptr(), u.data_ptr() if stochastic else None, words.data_ptr(),
        codes.data_ptr(), R, n, k, C, Wc, lane, b, *ref.quant_step(bits, clip),
        bits, int(stochastic), _stream(x.device))
    _raise_on(err, "quantize_pack_chunk")
    LAUNCHES["quantize_pack_chunk"] += 1
    return words, codes


def repack(packed: torch.Tensor, acc: torch.Tensor, bits: int, size: int, *,
           hop: int = 0, lane_bits: int = 0, sum_of: int = 1,
           bias: Optional[int] = None, axis_size: int = 0,
           inner: int = 1) -> torch.Tensor:
    """The ring hop's accumulate, in place: for words (R, W) and int32 acc
    (R, size), ``acc[r] += unpack(packed[src])`` un-biased by sum_of·G (or
    ``bias``), src the row ``hop`` steps back along one axis of the cohort
    grid: ``axis_size`` entries (default R) of ``inner`` rows each, the rows
    stacked row-major (``ref.repack_ref``).  The defaults read row
    (r - hop) mod R.  Returns ``acc``."""
    lane, cpw, b = _wire_args(bits, lane_bits, sum_of, bias)
    if packed.dim() != 2 or acc.shape != (packed.shape[0], size):
        raise ValueError(f"need packed (R, W) and acc (R, {size}), got "
                         f"{tuple(packed.shape)} and {tuple(acc.shape)}")
    if size > cpw * packed.shape[1]:
        raise ValueError(f"size {size} does not fit {packed.shape[1]} words "
                         f"of {cpw} codes")
    R = packed.shape[0]
    axis = int(axis_size) or R
    if axis < 1 or inner < 1 or R % (axis * inner):
        raise ValueError(f"{R} rows do not stack an axis of {axis} entries "
                         f"with {inner} rows each")
    if not _on_cuda(packed, "packed"):
        return ref.repack_ref(packed, acc, bits, size, hop=hop, lane_bits=lane,
                              sum_of=sum_of, bias=bias, axis_size=axis,
                              inner=inner)
    _check(packed, torch.int32, packed.device, "packed")
    _check(acc, torch.int32, packed.device, "acc")
    W = packed.shape[1]
    err = build.library("pack").repro_repack(
        packed.data_ptr(), acc.data_ptr(), R, size, W, int(hop) % axis, axis,
        int(inner), lane, b, _stream(packed.device))
    _raise_on(err, "repack")
    LAUNCHES["repack"] += 1
    return acc


def pack_sums(codes: torch.Tensor, bits: int, *, lane_bits: int = 0,
              sum_of: int = 1, bias: Optional[int] = None) -> torch.Tensor:
    """int32 partial sums (R, n) -> words (R, ceil(n/cpw)), int32 tensors
    holding the uint32 pattern: bias by sum_of·G (or ``bias``) modulo 2^32
    and pack planar at ``lane_bits`` (default ``bits``).  Padding lanes are
    raw 0."""
    lane, cpw, b = _wire_args(bits, lane_bits, sum_of, bias)
    _check_rows(codes)
    if not _on_cuda(codes, "codes"):
        return ref.pack_sums_ref(codes, bits, lane_bits=lane, sum_of=sum_of,
                                 bias=bias)
    _check(codes, torch.int32, codes.device, "codes")
    R, n = codes.shape
    W = wire.packed_words(n, bits, lane_bits=lane)
    words = torch.empty((R, W), dtype=torch.int32, device=codes.device)
    err = build.library("pack").repro_pack_sums(
        codes.data_ptr(), words.data_ptr(), R, n, W, lane, b,
        _stream(codes.device))
    _raise_on(err, "pack_sums")
    LAUNCHES["pack_sums"] += 1
    return words


def null_kernel(blocks: int, device: torch.device) -> None:
    """An empty kernel of ``blocks`` blocks of 256 threads on ``device``'s
    current stream, launched through the wire kernels' ctypes path: the
    launch floor ``chip_smoke.py`` times beside them.  No round calls it,
    and ``LAUNCHES`` does not count it."""
    if device.type != "cuda":
        raise ValueError(f"null_kernel runs only on the card, not {device}")
    err = build.library("pack").repro_null_kernel(int(blocks), _stream(device))
    _raise_on(err, "null_kernel")


class QmatmulPlan(NamedTuple):
    tiles: int      # output tiles of 64 x 64
    split: int      # blocks of one cluster that share a tile's K
    x_vec: int      # staging of x in bytes: 16, else 1 (row stride or
                    # pointer not a multiple of 16)
    w_vec: int      # the same for w


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _qmatmul_operands(x_q: torch.Tensor, w_q: torch.Tensor) -> Tuple[int, int, int]:
    """(M, K, N) of two checked CUDA operands."""
    _check(x_q, torch.int8, x_q.device, "x_q")
    _check(w_q, torch.int8, x_q.device, "w_q")
    (M, K), N = x_q.shape, w_q.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"qmatmul shape {(M, K, N)} is too large")
    return M, K, N


def qmatmul_plan(x_q: torch.Tensor, w_q: torch.Tensor) -> QmatmulPlan:
    """The launch ``qmatmul`` makes for these CUDA operands, as the kernel's
    C side picks it from the shapes, the pointers and the card's SM count."""
    M, K, N = _qmatmul_operands(x_q, w_q)
    plan = (ctypes.c_int * 4)()
    build.library("qmatmul").repro_qmatmul_plan(
        x_q.data_ptr(), w_q.data_ptr(), M, N, K, _sms(x_q.device), plan)
    return QmatmulPlan(*plan)


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: float,
            sw: float) -> torch.Tensor:
    """int8 x_q (M, K) @ int8 w_q (K, N) -> f32 (M, N): the exact int32
    product times float32(float32(sx)·float32(sw)), the per-tensor scales."""
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"need x_q (M, K) and w_q (K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if not _on_cuda(x_q, "x_q"):
        return ref.qmatmul_ref(x_q, w_q, sx, sw)
    M, K, N = _qmatmul_operands(x_q, w_q)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = build.library("qmatmul").repro_qmatmul(
        x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), M, N, K,
        _sms(x_q.device), float(np.float32(sx) * np.float32(sw)),
        _stream(x_q.device))
    _raise_on(err, "qmatmul")
    LAUNCHES["qmatmul"] += 1
    return out


def _fma_rows(t: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(rows, n, row stride) of a float32 tensor whose elements lie in rows
    of n contiguous ones: a contiguous tensor is one row; a leaf of the flat
    (K, D) parameters, (K, *shape) with each row's leaf contiguous, is K."""
    if t.is_contiguous():
        return 1, t.numel(), t.numel()
    if t.dim() >= 2:
        try:
            rows = t.view(t.shape[0], -1)
        except RuntimeError:
            rows = None
        if rows is not None and rows.stride(1) == 1:
            return rows.shape[0], rows.shape[1], rows.stride(0)
    raise ValueError(f"{what}: its elements are not rows of contiguous "
                     f"ones (strides {t.stride()})")


class FmaStepPlan(NamedTuple):
    vector: bool    # the 16-byte path: both pointers on a 16-byte boundary,
                    # n and the row strides multiples of 4; else one element
                    # at a time
    tiles: int      # tiles of 256 threads' 4 vectors (elements), in one row
    blocks: int     # blocks launched: one wave, capped by the tiles


def fma_step_plan(w: torch.Tensor, g: torch.Tensor) -> FmaStepPlan:
    """The launch ``fma_step_`` makes for these CUDA tensors."""
    rows, n, ws = _fma_rows(w, "w")
    g = g.contiguous()
    out = (ctypes.c_longlong * 3)()
    build.library("sgd").repro_sgd_plan(w.data_ptr(), g.data_ptr(), rows, n,
                                        ws, n, out)
    return FmaStepPlan(bool(out[0]), out[1], out[2])


def fma_step_(w: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """The float32 SGD step in place: ``w = fma(-eta, g, w)``, rounded once,
    as XLA:CPU contracts the reference's ``w - eta * g.astype(w.dtype)``.
    ``eta`` must be a float32 value (it is negated exactly).  ``w`` may be
    a strided leaf of the flat parameters (``_fma_rows``); ``g`` has its
    shape.  Returns ``w``."""
    if w.shape != g.shape:
        raise ValueError(f"w {tuple(w.shape)} and g {tuple(g.shape)} differ")
    if float(np.float32(eta)) != float(eta):
        raise ValueError(f"eta {eta!r} is not a float32 value")
    if w.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"w and g must be float32, got {w.dtype}, {g.dtype}")
    if not _on_cuda(w, "w"):
        neg = torch.tensor(-float(eta), dtype=torch.float32)
        return w.copy_(ref.fma32(neg, g, w))
    rows, n, ws = _fma_rows(w, "w")
    g = g.contiguous()
    _check(g, torch.float32, w.device, "g")
    err = build.library("sgd").repro_sgd_step_f32(
        w.data_ptr(), g.data_ptr(), rows, n, ws, n, -float(eta),
        _stream(w.device))
    _raise_on(err, "fma_step")
    LAUNCHES["fma_step"] += 1
    return w
