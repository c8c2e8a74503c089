"""Per-round packet-error realization tied to the FBL operating point.

The drop probability follows the finite-blocklength operating point each
device runs at, at its assigned power (``population.power``):

* a device whose achieved rate clears the deadline-miss threshold
  (``min_rate``, ``population.power.min_rate``; 0 without a deadline)
  decodes with the target error probability q (paper §II-D2);
* a device in outage (rate at or below it) cannot finish the uplink
  inside the round deadline, and its packet drops w.p. 1.

The module also owns the opt-in unbiased reweighting
(``FleetConfig.error_reweight``): each surviving update is scaled by
1/(1-q), and the aggregate divided by the expected surviving mass of the
reachable cohort, so that over drop realizations

    E[ Σ α_k λ_k Δ_k / (1-q) ] = Σ α_k Δ_k        (λ_k ~ Bern(1-q))

— the inverse-probability-weighting estimator.  Outage devices (survival
probability 0) are left out of the expected mass.
:func:`reweighted_aggregate` is the per-α form the simulator runs, through
``masked_aggregate`` with a given denominator; :func:`ipw_delta_scale`
is the post-aggregation scalar the cohort round multiplies onto the
eq.-6-normalized collective output (exact for its uniform weights).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

EPS = 1e-12


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """float32(value) as a 0-dim tensor on ``like``'s device, made by a
    fill (no copy from the host): a divisor that divides exactly."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def below(rates: torch.Tensor, min_rate: float) -> torch.Tensor:
    """1.0 where the rate is at or below float32(``min_rate``)."""
    return (rates <= _scalar(min_rate, rates)).float()


def packet_error_probs(rates: torch.Tensor, error_prob: float,
                       min_rate: float = 0.0) -> torch.Tensor:
    """Per-device drop probability: q where the rate clears ``min_rate``,
    1.0 in outage."""
    return torch.where(rates > _scalar(min_rate, rates),
                       _scalar(error_prob, rates), _scalar(1.0, rates))


def realize_packet_success(gen: Optional[torch.Generator], rates: torch.Tensor,
                           error_prob: float, min_rate: float = 0.0, *,
                           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """λ draws: 1 w.p. 1-q per device, always 0 in outage; ``u`` (the
    uniforms, rates' shape) replaces the draw from ``gen``."""
    if u is None:
        if gen is None:
            raise ValueError("pass a generator, or the uniforms")
        u = torch.rand(rates.shape, generator=gen, device=rates.device)
    return (u >= packet_error_probs(rates, error_prob, min_rate)).float()


def _survival(error_prob: float) -> float:
    """max(1 - float32(q), EPS) in float32, as the reference rounds it."""
    one_minus = np.float32(1.0) - np.float32(error_prob)
    return float(max(one_minus, np.float32(EPS)))


def inverse_prob_weights(lam: torch.Tensor, error_prob: float) -> torch.Tensor:
    """λ/(1-q) — the unbiased inverse-probability participation weights."""
    return lam / _scalar(_survival(error_prob), lam)


def _reachable(valid: torch.Tensor, rates: Optional[torch.Tensor],
               min_rate: float = 0.0) -> torch.Tensor:
    """Slots whose device can survive at all: valid and not in outage."""
    if rates is None:
        return valid
    return valid * (rates > _scalar(min_rate, rates)).float()


def reweighted_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                         alphas: torch.Tensor, valid: torch.Tensor,
                         lam: torch.Tensor, error_prob: float,
                         rates: Optional[torch.Tensor] = None,
                         min_rate: float = 0.0) -> torch.Tensor:
    """The unbiased aggregate w + Σ α λ Δ/(1-q) / max(Σ_reach α, EPS).

    w (D,), deltas (K, D), the rest (K,).  The numerator is eq. 6's chain
    of fused multiply-adds over the weights α·reach·λ/(1-q) in k order; the
    denominator, the summed α of the reachable slots in k order from 0
    (one small add a slot, as the reference's sum runs), goes to
    ``masked_aggregate`` as its divisor, so the result rounds once, as the
    reference's does, and is never eq. 6's output rescaled.
    """
    reach = _reachable(valid, rates, min_rate)
    wts = alphas * reach * inverse_prob_weights(lam, error_prob)
    mass = alphas * reach
    total = torch.zeros((), dtype=torch.float32, device=mass.device)
    for k in range(mass.shape[0]):
        total = total + mass[k]
    den = torch.clamp(total, min=EPS)
    return w + ops.masked_aggregate(deltas.contiguous(),
                                    wts.float().contiguous(), EPS, den=den)


def ipw_delta_scale(lam: torch.Tensor, valid: torch.Tensor,
                    rates: Optional[torch.Tensor], error_prob: float,
                    min_rate: float = 0.0) -> torch.Tensor:
    """The scalar turning an eq.-6-normalized aggregate with uniform
    weights (the cohort round's α = 1/C) into the IPW estimator:
    Σλ / max((1-q)·Σ reach, EPS); 0 when nobody survives."""
    reach = _reachable(valid, rates, min_rate)
    den = torch.clamp(_scalar(np.float32(1.0) - np.float32(error_prob), lam)
                      * reach.sum(), min=EPS)
    return lam.sum() / den
