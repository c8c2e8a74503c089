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
"""
from __future__ import annotations

from typing import Dict

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
