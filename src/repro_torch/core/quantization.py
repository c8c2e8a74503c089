"""Stochastic fixed-point quantization (paper §II-A/B), through the kernels.

The paper's three-step procedure:
  1. scale up:   w_Q = clip(w, [-1,1]) * G,  G = 2^(n-1)
  2. stochastic rounding:  floor(w_Q) w.p. 1-frac, floor(w_Q)+1 w.p. frac
  3. scale down: w_r = R(w_Q) / G

Codes live in the signed n-bit range [-G, G-1]; +G (from x == +clip)
saturates to G-1.  Every function takes its rounding noise ``u`` ~ U[0,1)
as a tensor, so a test can feed the reference's own draws; callers that
have none draw it with their own ``torch.Generator``.  The quantize and
dequantize steps always go through ``kernels.ops`` (the CUDA kernels on a
CUDA tensor, their plain versions on a CPU one).

Parameter trees are dicts; their flat order is the sorted key order, which
is the JAX pytree leaf order of the reference.

The module also owns the packed wire format (``pack_codes`` /
``unpack_codes`` and the payload counts): n-bit codes laid planar into
32-bit words.  Words are held as int32 tensors carrying the uint32 bit
pattern, because PyTorch has no shift, add or sum on ``torch.uint32``; the
plain code here computes in int64 and keeps the low 32 bits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch import convert
from repro_torch.config.base import QuantConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def quantize_codes(x: torch.Tensor, u: torch.Tensor | None, bits: int, *,
                   clip: float = 1.0, stochastic: bool = True) -> torch.Tensor:
    """Integer codes (int32) in [-G, G-1] of ``x`` clipped to [-clip, clip]."""
    if bits <= 0:
        raise ValueError("bits must be positive for quantization")
    u = u.contiguous() if u is not None else None
    return ops.stochastic_quantize_codes(x.contiguous(), u, bits, clip=clip,
                                         stochastic=stochastic)


def dequantize_codes(codes: torch.Tensor, bits: int, *,
                     clip: float = 1.0) -> torch.Tensor:
    """codes · clip/G as float32 (the Pallas kernel's multiply; see ROADMAP
    C for the 1-ulp difference from the reference's pure divide)."""
    return ops.dequantize_codes(codes.contiguous(), bits, clip=clip)


def quantize(x: torch.Tensor, u: torch.Tensor | None,
             cfg: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize (the value actually used for compute/transmission)."""
    if not cfg.enabled:
        return x
    codes = quantize_codes(x, u, cfg.bits, clip=cfg.clip,
                           stochastic=cfg.stochastic)
    return dequantize_codes(codes, cfg.bits, clip=cfg.clip).to(x.dtype)


def quantize_tree(tree: Params, u: torch.Tensor | None,
                  cfg: QuantConfig) -> Params:
    """Quantize every leaf; ``u`` is the flat noise in leaf order."""
    if not cfg.enabled:
        return tree
    flat = quantize(convert.flatten_params(tree), u, cfg)
    return convert.unflatten_params(flat, convert.param_shapes(tree))


def quantize_tree_codes(tree: Params, u: torch.Tensor | None,
                        cfg: QuantConfig) -> torch.Tensor:
    """Flat int32 codes of every leaf in leaf order (what crosses the wire)."""
    return quantize_codes(convert.flatten_params(tree), u, cfg.bits,
                          clip=cfg.clip, stochastic=cfg.stochastic)


# ---------------------------------------------------------------------------
# Bit packing: n-bit codes -> dense 32-bit words (the wire format).
#
# Codes in [-G, G-1] are biased to unsigned [0, 2^bits-1] and laid out
# planar: the flat code vector (padded to cpw·W, W = ceil(n/cpw)) is viewed
# as (cpw, W) planes and plane j occupies bit-lane [j·lane, (j+1)·lane) of
# word w.  An aggregating collective widens the lane to
# bits + ceil(log2(num_shards)) so a sum of packed words cannot carry
# across lanes.  Every function takes leading batch dims (one row per
# cohort) in front of the flat axis.
# ---------------------------------------------------------------------------

_U32 = (1 << 32) - 1


def to_int32_pattern(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 holding their low 32 bits (the uint32 pattern)."""
    v = v & _U32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def from_int32_pattern(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return words.to(torch.int64) & _U32


def packed_lane_bits(bits: int, num_shards: int = 1) -> int:
    """Bit-lane width so a sum over ``num_shards`` biased codes cannot carry."""
    guard = math.ceil(math.log2(num_shards)) if num_shards > 1 else 0
    return bits + guard


def lane_bias(lane: int) -> int:
    """Mid-lane bias 2^(lane-1), the lane-symmetric alternative to the
    default ``sum_of``·G bias."""
    return 1 << (int(lane) - 1)


def codes_per_word(bits: int, *, lane_bits: int = 0) -> int:
    """How many codes one 32-bit word holds at the given lane width."""
    lane = lane_bits or bits
    if lane > 32:
        raise ValueError(f"lane width {lane} exceeds the 32-bit container")
    return 32 // lane


def packed_words(n: int, bits: int, *, lane_bits: int = 0) -> int:
    """Number of 32-bit words packing ``n`` codes."""
    return -(-int(n) // codes_per_word(bits, lane_bits=lane_bits))


def _bias(bits: int, sum_of: int, bias: Optional[int]) -> int:
    return int(2 ** (bits - 1)) * int(sum_of) if bias is None else int(bias)


def pack_codes(codes: torch.Tensor, bits: int, *, lane_bits: int = 0,
               sum_of: int = 1, bias: Optional[int] = None) -> torch.Tensor:
    """Pack int32 codes (..., n) into words (..., W) as int32 bit patterns.

    ``sum_of`` packs partial sums of that many codes, biased by sum_of·G;
    ``bias`` overrides that bias.  The bias is added modulo 2^32, exact up
    to the full 32-bit lane.  Padding lanes (beyond n) hold raw 0.
    """
    lane = lane_bits or bits
    cpw = codes_per_word(bits, lane_bits=lane)
    n = codes.shape[-1]
    W = packed_words(n, bits, lane_bits=lane)
    biased = (codes.to(torch.int64) + _bias(bits, sum_of, bias)) & _U32
    biased = torch.nn.functional.pad(biased, (0, cpw * W - n))
    planes = biased.reshape(*codes.shape[:-1], cpw, W)
    shifts = (torch.arange(cpw, dtype=torch.int64, device=codes.device)
              * lane)[:, None]
    return to_int32_pattern((planes << shifts).sum(-2))


def unpack_codes(packed: torch.Tensor, bits: int, size: int, *,
                 lane_bits: int = 0, sum_of: int = 1,
                 bias: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: words (..., W) -> int32 codes
    (..., size), un-biased modulo 2^32.  ``sum_of`` is the number of packed
    buffers summed into ``packed`` (one +G per summand per lane)."""
    lane = lane_bits or bits
    cpw = codes_per_word(bits, lane_bits=lane)
    words = from_int32_pattern(packed)
    shifts = (torch.arange(cpw, dtype=torch.int64, device=packed.device)
              * lane)[:, None]
    lanes = (words[..., None, :] >> shifts) & ((1 << lane) - 1)
    flat = lanes.reshape(*packed.shape[:-1], -1)[..., :int(size)]
    return to_int32_pattern(flat - _bias(bits, sum_of, bias))


def packed_payload_bits(num_params: int, bits: int, *,
                        num_shards: int = 1) -> int:
    """Wire bits of the packed uplink: 32 · ceil(d / cpw) at the guard lane."""
    lane = packed_lane_bits(bits, num_shards)
    return 32 * packed_words(num_params, bits, lane_bits=lane)


def ring_payload_bits(num_params: int, bits: int,
                      axis_sizes: Sequence[int]) -> int:
    """Per-device wire bits of the ring, summed over every hop: level l
    ships K_l - 1 full vectors of partial sums of m_l codes at lane
    ``packed_lane_bits(bits, m_l)``, m_l the product of earlier axes."""
    total, m = 0, 1
    for k in axis_sizes:
        k = int(k)
        if k <= 1:
            continue
        lane = packed_lane_bits(bits, m)
        total += (k - 1) * 32 * packed_words(num_params, bits, lane_bits=lane)
        m *= k
    return total


def rsag_payload_bits(num_params: int, bits: int,
                      axis_sizes: Sequence[int]) -> int:
    """Per-device wire bits of reduce-scatter + all-gather: scatter hop h
    ships one ceil(d/K) chunk at lane ``packed_lane_bits(bits, m·h)``, the
    gather K-1 chunks at the final lane ``packed_lane_bits(bits, m·K)``."""
    total, m = 0, 1
    for k in axis_sizes:
        k = int(k)
        if k <= 1:
            continue
        C = -(-int(num_params) // k)
        for h in range(1, k):
            lane = packed_lane_bits(bits, m * h)
            total += 32 * packed_words(C, bits, lane_bits=lane)
        lane_k = packed_lane_bits(bits, m * k)
        total += (k - 1) * 32 * packed_words(C, bits, lane_bits=lane_k)
        m *= k
    return total


def quantization_variance_bound(bits: int, clip: float = 1.0) -> float:
    """Per-element variance bound of stochastic rounding: step²/4, step = clip/2^(n-1)."""
    step = clip / (2.0 ** (bits - 1))
    return step * step / 4.0


def payload_bits(num_params: int, bits: int) -> int:
    """Uplink payload d_n^u = d^u * n (paper §II-D2)."""
    return int(num_params) * int(bits)


# ---------------------------------------------------------------------------
# Straight-through estimator for quantization-aware local training (QNN).
# Forward: quantized weights; backward: identity inside the clip interval.
# ---------------------------------------------------------------------------

class FakeQuantSTE(torch.autograd.Function):
    """Forward: the quantize and dequantize kernels.  Backward: the clipped
    straight-through estimator ``g · (|x| <= clip)``."""

    @staticmethod
    def forward(ctx, x, u, bits: int, clip: float, stochastic: bool):
        ctx.save_for_backward(x)
        ctx.clip = clip
        codes = quantize_codes(x, u, bits, clip=clip, stochastic=stochastic)
        return dequantize_codes(codes, bits, clip=clip).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= ctx.clip).to(g.dtype), None, None, None, None


def fake_quant_ste(x: torch.Tensor, u: torch.Tensor | None, bits: int,
                   clip: float, stochastic: bool) -> torch.Tensor:
    return FakeQuantSTE.apply(x, u, bits, clip, stochastic)


def fake_quant_params(params: Params, u: torch.Tensor | None,
                      cfg: QuantConfig) -> Params:
    """STE fake-quantization of a parameter dict (used inside the local
    loss); ``u`` is the flat noise over the leaves in leaf order."""
    if not (cfg.enabled and cfg.quantize_training):
        return params
    flat = fake_quant_ste(convert.flatten_params(params), u, cfg.bits,
                          cfg.clip, cfg.stochastic)
    return convert.unflatten_params(flat, convert.param_shapes(params))
