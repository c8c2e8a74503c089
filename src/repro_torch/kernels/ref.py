"""Plain PyTorch versions of the CUDA kernels.

The CPU path and the tests run these; on the card only ``chip_smoke.py``
calls them, as the yardstick the kernels are held to.  Each follows the op
order of the Pallas kernel it stands for (``repro/kernels/quantize.py``,
``repro/kernels/aggregate.py``, ``repro/kernels/pack.py``,
``repro/kernels/qmatmul.py``), so the quantizer is bit-exact with it.

The wire versions take a leading row (cohort) dimension: each row is one
call of the reference's kernel.  Their words are int32 tensors holding
the uint32 bit pattern (see ``core/quantization.py``).

Divisors, multipliers and clamp bounds are 0-dim tensors on the input's
device, never Python scalars: on CUDA, PyTorch turns
``tensor / python_float`` into a multiply by the reciprocal, which would
round differently from the kernel.
They are made once per value and device, so a call holds no host-to-device
copy.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

# the module, not its names: core.quantization imports this module in turn
from repro_torch.core import quantization as wire


@functools.lru_cache(maxsize=64)
def _scalar_on(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return _scalar_on(float(value), like.device)


def quant_step(bits: int, clip: float) -> Tuple[float, float]:
    """The quantizer's bound float32(clip) and scale float32(2^(bits-1)/clip),
    each rounded once from the Python double ``clip``, as the reference's
    weak-typed scalars are (``repro/kernels/ref.py``)."""
    clip = float(clip)
    return float(np.float32(clip)), float(np.float32(2.0 ** (bits - 1) / clip))


def stochastic_quantize_ref(x: torch.Tensor, u: torch.Tensor | None,
                            bits: int, *, clip: float = 1.0,
                            stochastic: bool = True) -> torch.Tensor:
    """Integer codes in [-G, G-1], G = 2^(bits-1); u ~ U[0,1) same shape.

    clip(x, -bound, bound)·scale (``quant_step``), then floor(· + u) or
    round half-to-even: the reference's multiply.
    """
    g = int(2 ** (bits - 1))
    bound, scale = quant_step(bits, clip)
    xq = torch.clamp(x.float(), _scalar(-bound, x),
                     _scalar(bound, x)) * _scalar(scale, x)
    codes = torch.floor(xq + u) if stochastic else torch.round(xq)
    return torch.clamp(codes, -g, g - 1).to(torch.int32)


def dequantize_ref(codes: torch.Tensor, bits: int, *,
                   clip: float = 1.0) -> torch.Tensor:
    """codes · float32(clip/G), as the Pallas kernel multiplies."""
    return codes.float() * _scalar(clip / float(2 ** (bits - 1)), codes)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once (a fused multiply-add), for float32
    tensors that broadcast.

    The only plain version that computes in float64: the product of two
    float32 values is exact there (24 + 24 bits fit in 53); the sum with
    c is rounded to odd (TwoSum gives its error e; where e != 0 and the
    last bit of the sum is even, step its bit pattern one ulp towards e),
    then cast to float32 once.  Rounding to odd in 53 bits and then to
    nearest in 24 is correct rounding, as 53 >= 24 + 2 (Boldo and
    Melquiond).  The sum is not 0 where e != 0, so the step never crosses
    zero."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = bits + torch.where((e != 0) & ((bits & 1) == 0), step, 0)
    return bits.view(torch.float64).float()


def masked_aggregate_ref(updates: torch.Tensor, weights: torch.Tensor,
                         eps: float = 1e-12,
                         den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Error-aware weighted aggregation (paper eq. 6).

    updates: (K, D) client deltas (f32 or int32); weights: (K,) = α_k·λ_k.
    Returns Σ_k w_k·u_k / max(Σ_k w_k, eps) in the reference's order, as
    XLA:CPU runs its Pallas kernel and its jitted ``error_aware_aggregate``
    (the multiply contracted into the reduce): ``acc = fma(w_k, u_k, acc)``
    for k = 0..K-1 from 0, the denominator summed in k order from 0.  A
    given ``den`` (a 0-dim float32 tensor on the updates' device) divides
    the same numerator as it is: the fleet's inverse-probability aggregate.
    """
    w = weights.float()
    acc = torch.zeros(updates.shape[1:], dtype=torch.float32,
                      device=updates.device)
    total = torch.zeros((), dtype=torch.float32, device=updates.device)
    for k in range(updates.shape[0]):
        acc = fma32(w[k], updates[k].float(), acc)
        total = total + w[k]
    return acc / (torch.clamp(total, min=eps) if den is None else den)


def quantize_pack_ref(x: torch.Tensor, u: Optional[torch.Tensor], bits: int, *,
                      clip: float = 1.0, lane_bits: int = 0,
                      stochastic: bool = True) -> torch.Tensor:
    """x, u (R, n) -> words (R, ceil(n/cpw)): quantize, then pack planar
    with the +G bias at ``lane_bits``."""
    codes = stochastic_quantize_ref(x, u, bits, clip=clip, stochastic=stochastic)
    return wire.pack_codes(codes, bits, lane_bits=lane_bits)


def unpack_dequantize_ref(packed: torch.Tensor, bits: int, size: int, *,
                          clip: float = 1.0, lane_bits: int = 0,
                          sum_of: int = 1,
                          bias: Optional[int] = None) -> torch.Tensor:
    """words (..., W) -> f32 (..., size): unpack, un-bias by sum_of·G (or
    ``bias``) modulo 2^32, times float32(clip/G)."""
    codes = wire.unpack_codes(packed, bits, size, lane_bits=lane_bits,
                         sum_of=sum_of, bias=bias)
    return dequantize_ref(codes, bits, clip=clip)


def quantize_pack_chunk_ref(x: torch.Tensor, u: Optional[torch.Tensor],
                            bits: int, *, clip: float = 1.0,
                            lane_bits: int = 0, stochastic: bool = True,
                            num_chunks: int = 1, bias: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, u (R, n) -> (words (R, k, Wc), codes (R, k, C)), C = ceil(n/k):
    quantize, pad each row's codes with real zero codes to k·C, split into
    k chunks and pack each at ``lane_bits`` with the +G bias (or
    ``bias``)."""
    codes = stochastic_quantize_ref(x, u, bits, clip=clip, stochastic=stochastic)
    R, n = codes.shape
    k = int(num_chunks)
    C = -(-n // k)
    chunks = torch.nn.functional.pad(codes, (0, k * C - n)).reshape(R, k, C)
    return wire.pack_codes(chunks, bits, lane_bits=lane_bits, bias=bias), chunks


def pack_sums_ref(codes: torch.Tensor, bits: int, *, lane_bits: int = 0,
                  sum_of: int = 1, bias: Optional[int] = None) -> torch.Tensor:
    """int32 partial sums (R, n) -> words (R, ceil(n/cpw)): bias by
    sum_of·G (or ``bias``) modulo 2^32 and pack planar at ``lane_bits``."""
    return wire.pack_codes(codes, bits, lane_bits=lane_bits, sum_of=sum_of,
                           bias=bias)


def repack_ref(packed: torch.Tensor, acc: torch.Tensor, bits: int, size: int,
               *, hop: int = 0, lane_bits: int = 0, sum_of: int = 1,
               bias: Optional[int] = None, axis_size: int = 0,
               inner: int = 1) -> torch.Tensor:
    """The ring hop's accumulate, in place: ``acc[r] += unpack(packed[src])``
    for words (R, W) and acc (R, size) int32.  The rows stack row-major over
    the cohort grid; src is the row of r's group whose index on an axis of
    ``axis_size`` entries (default R), ``inner`` rows a step, is ``hop``
    less, modulo ``axis_size``.  Returns acc."""
    R = packed.shape[0]
    K = int(axis_size) or R
    span = K * int(inner)
    r = torch.arange(R, device=packed.device)
    src = ((r // span) * span + ((r // inner) % K - int(hop)) % K * inner
           + r % inner)
    acc += wire.unpack_codes(packed[src], bits, size, lane_bits=lane_bits,
                             sum_of=sum_of, bias=bias)
    return acc


def qmatmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx: float,
                sw: float) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> f32: the exact integer product, rounded
    once to float32, times float32(float32(sx)·float32(sw)).  The product is
    taken in float64, where every partial sum of int8 products is an exact
    integer for K < 2^38 (PyTorch on CUDA has no int32 matrix product)."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    scale = np.float32(sx) * np.float32(sw)
    return acc.to(torch.float32) * _scalar(float(scale), acc)
