"""Plain PyTorch versions of the CUDA kernels.

The CPU path and the tests run these; on the card only ``chip_smoke.py``
calls them, as the yardstick the kernels are held to.  Each follows the op
order of the Pallas kernel it stands for (``repro/kernels/quantize.py``,
``repro/kernels/aggregate.py``), so the quantizer is bit-exact with it.

Divisors and multipliers are 0-dim tensors on the input's device, never
Python scalars: on CUDA, PyTorch turns ``tensor / python_float`` into a
multiply by the reciprocal, which would round differently from the kernel.
They are made once per value and device, so a call holds no host-to-device
copy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _scalar_on(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return _scalar_on(float(value), like.device)


def stochastic_quantize_ref(x: torch.Tensor, u: torch.Tensor | None,
                            bits: int, *, clip: float = 1.0,
                            stochastic: bool = True) -> torch.Tensor:
    """Integer codes in [-G, G-1], G = 2^(bits-1); u ~ U[0,1) same shape.

    clip(x/clip, -1, 1)·G, then floor(· + u) or round half-to-even.
    """
    g = int(2 ** (bits - 1))
    xq = torch.clamp(x.float() / _scalar(clip, x), -1.0, 1.0) * _scalar(g, x)
    codes = torch.floor(xq + u) if stochastic else torch.round(xq)
    return torch.clamp(codes, -g, g - 1).to(torch.int32)


def dequantize_ref(codes: torch.Tensor, bits: int, *,
                   clip: float = 1.0) -> torch.Tensor:
    """codes · float32(clip/G), as the Pallas kernel multiplies."""
    return codes.float() * _scalar(clip / float(2 ** (bits - 1)), codes)


def masked_aggregate_ref(updates: torch.Tensor, weights: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    """Error-aware weighted aggregation (paper eq. 6).

    updates: (K, D) client deltas (f32 or int32); weights: (K,) = α_k·λ_k.
    Returns Σ_k w_k·u_k / max(Σ_k w_k, eps).
    """
    w = weights.float()
    num = (w[:, None] * updates.float()).sum(0)
    return num / torch.clamp(w.sum(), min=eps)
