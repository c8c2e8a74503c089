"""Server-side aggregation of one round's client deltas (paper eq. 5/6).

The deltas arrive stacked as one flat (K, D) tensor (clients × parameters
in leaf order) and the model as its flat (D,) vector.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

EPS = 1e-12


def naive_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                    lambdas: torch.Tensor) -> torch.Tensor:
    """eq. 5 with drops zeroed: w + (1/K) Σ λ_k Δ_k.  Plain torch: the sum
    is divided by K, not by the surviving weight, so it is not the
    ``masked_aggregate`` kernel's function."""
    K = lambdas.shape[0]
    return w + (deltas * lambdas[:, None]).sum(0) / K


def error_aware_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                          alphas: torch.Tensor,
                          lambdas: torch.Tensor) -> torch.Tensor:
    """eq. 6: surviving updates renormalized by the surviving data mass,
    w + Σ α_k λ_k Δ_k / max(Σ α_k λ_k, eps), through the kernel."""
    wts = (alphas * lambdas).float().contiguous()
    return w + ops.masked_aggregate(deltas.contiguous(), wts, eps=EPS)
