"""Kernel wrappers: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
its plain version in ``ref.py``.  A tensor anywhere else raises.

Each wrapper checks device, dtype, contiguity and shape, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch reports an error.  ``LAUNCHES``
counts kernel launches per wrapper (never plain-version calls), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"stochastic_quantize_codes": 0,
                            "dequantize_codes": 0, "masked_aggregate": 0}


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


def stochastic_quantize_codes(x: torch.Tensor, u: Optional[torch.Tensor],
                              bits: int, *, clip: float = 1.0,
                              stochastic: bool = True) -> torch.Tensor:
    """f32 ``x`` and noise ``u`` (same shape) -> int32 codes in [-G, G-1].

    ``u`` is read only when ``stochastic``; nearest rounding may pass None.
    """
    _check_bits(bits)
    if stochastic and (u is None or u.shape != x.shape):
        raise ValueError("stochastic quantization needs u of x's shape")
    if not _on_cuda(x, "x"):
        return ref.stochastic_quantize_ref(x, u, bits, clip=clip,
                                           stochastic=stochastic)
    _check(x, torch.float32, x.device, "x")
    if stochastic:
        _check(u, torch.float32, x.device, "u")
    codes = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    err = build.library("quantize").repro_quantize_codes(
        x.data_ptr(), u.data_ptr() if stochastic else None, codes.data_ptr(),
        x.numel(), float(np.float32(clip)), bits, int(stochastic),
        _stream(x.device))
    _raise_on(err, "stochastic_quantize_codes")
    LAUNCHES["stochastic_quantize_codes"] += 1
    return codes


def dequantize_codes(codes: torch.Tensor, bits: int, *,
                     clip: float = 1.0) -> torch.Tensor:
    """int32 codes -> f32 ``codes · float32(clip/G)``."""
    _check_bits(bits)
    if not _on_cuda(codes, "codes"):
        return ref.dequantize_ref(codes, bits, clip=clip)
    _check(codes, torch.int32, codes.device, "codes")
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    inv_gain = float(np.float32(clip / float(2 ** (bits - 1))))
    err = build.library("quantize").repro_dequantize_codes(
        codes.data_ptr(), out.data_ptr(), codes.numel(), inv_gain,
        _stream(codes.device))
    _raise_on(err, "dequantize_codes")
    LAUNCHES["dequantize_codes"] += 1
    return out


def masked_aggregate(updates: torch.Tensor, weights: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """updates (K, D) f32/int32, weights (K,) f32 -> (D,) f32 (paper eq. 6)."""
    if updates.dim() != 2 or weights.shape != (updates.shape[0],):
        raise ValueError(f"need updates (K, D) and weights (K,), got "
                         f"{tuple(updates.shape)} and {tuple(weights.shape)}")
    if updates.shape[0] < 1:
        raise ValueError("masked_aggregate needs K >= 1")
    if not _on_cuda(updates, "updates"):
        return ref.masked_aggregate_ref(updates, weights, eps)
    if updates.dtype == torch.float32:
        fn = "repro_masked_aggregate_f32"
    elif updates.dtype == torch.int32:
        fn = "repro_masked_aggregate_i32"
    else:
        raise TypeError(f"updates must be float32 or int32, got {updates.dtype}")
    _check(updates, updates.dtype, updates.device, "updates")
    _check(weights, torch.float32, updates.device, "weights")
    K, D = updates.shape
    out = torch.empty(D, dtype=torch.float32, device=updates.device)
    err = getattr(build.library("aggregate"), fn)(
        updates.data_ptr(), weights.data_ptr(), out.data_ptr(), K, D,
        float(np.float32(eps)), _stream(updates.device))
    _raise_on(err, "masked_aggregate")
    LAUNCHES["masked_aggregate"] += 1
    return out
