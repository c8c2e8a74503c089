"""Cohort selection over the whole fleet: a masked ranking with a defined
tie order.

Every policy is a per-device score; selection takes the ``k`` highest of
``where(eligible, score, -inf)`` — O(N) work plus one sort, on the
fleet's device, no host round-trip.  Devices that are unavailable or
whose battery cannot cover the round cost score -inf and are never
selected; when fewer than ``k`` devices are eligible the surplus slots
hold ineligible devices with ``valid == 0`` and contribute nothing.

The reference ranks with ``jax.lax.top_k``, which puts the lower index
first among equal scores; ``torch.topk`` promises no order for ties on
CUDA.  Ties are common (every ineligible device scores -inf, and
``energy_aware`` batteries tie once drained), and the padded slots' ids
reach the telemetry, so the port ranks by a stable descending sort and
takes its first ``k``: the same order as ``top_k``.

Policies (``FleetConfig.selection``):

  uniform       a fresh U[0,1) score per device — a uniform random cohort
                over the eligible set.
  rate_aware    score = achieved FBL rate — the best channels.
  energy_aware  score = remaining battery — the fullest batteries.
  round_robin   score = -((device_idx - cursor) mod N) — a rotating scan
                from the carried cursor.
  lyapunov      score = V·(rate/mean rate) − drift·(cost/mean cost) at
                the assigned power (``population.power``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config.base import SELECTION_POLICIES
from repro_torch.population import power as ppower
from repro_torch.population.fleet import FleetState

POLICIES = SELECTION_POLICIES


def eligible_mask(state: FleetState, round_cost_j: torch.Tensor) -> torch.Tensor:
    """1.0 where a device may be selected: awake and able to pay the round."""
    return ((state.available > 0)
            & (state.battery_j >= round_cost_j)).float()


def policy_scores(policy: str, state: FleetState, rates: torch.Tensor,
                  gen: Optional[torch.Generator] = None,
                  round_cost_j: Optional[torch.Tensor] = None,
                  lyapunov_v: float = 0.2, *,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-device score vector the masked ranking orders (higher wins).

    ``u`` (N,) is the ``uniform`` policy's draw (else drawn from ``gen``);
    ``round_cost_j``/``lyapunov_v`` feed the ``lyapunov`` score only.
    """
    n = state.size
    if policy == "uniform":
        if u is None:
            if gen is None:
                raise ValueError("pass a generator, or the uniform scores")
            u = torch.rand(n, generator=gen, device=rates.device)
        return u
    if policy == "rate_aware":
        return rates
    if policy == "energy_aware":
        return state.battery_j
    if policy == "round_robin":
        idx = torch.arange(n, dtype=torch.int32, device=rates.device)
        # distance ahead of the cursor; nearest first, so negated
        return -torch.remainder(idx - state.rr_cursor, n).float()
    if policy == "lyapunov":
        cost = (round_cost_j if round_cost_j is not None
                else torch.zeros_like(rates))
        return ppower.lyapunov_selection_score(
            state.battery_j, state.capacity_j, rates, cost, lyapunov_v)
    raise ValueError(f"unknown selection policy {policy!r}; "
                     f"expected one of {POLICIES}")


def top_k_stable(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest scores, ties to the lower
    index, as ``jax.lax.top_k`` orders them."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[order], order


def masked_scores(policy: str, state: FleetState, rates: torch.Tensor,
                  gen: Optional[torch.Generator], round_cost_j: torch.Tensor,
                  lyapunov_v: float = 0.2, *,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (N,) float32 scores the cohort is ranked by: the policy's score
    where a device is eligible, -inf where it is not."""
    scores = policy_scores(policy, state, rates, gen, round_cost_j,
                           lyapunov_v, u=u)
    return torch.where(eligible_mask(state, round_cost_j) > 0,
                       scores.float(), float("-inf"))


def cohort_from_scores(masked: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(device_idx (k,) int64, valid (k,) f32)`` of the ``k`` best masked
    scores; a slot filled by an ineligible (-inf) device is not valid."""
    top, idx = top_k_stable(masked, k)
    return idx, torch.isfinite(top).float()


def select_cohort(policy: str, state: FleetState, rates: torch.Tensor, k: int,
                  gen: Optional[torch.Generator], round_cost_j: torch.Tensor,
                  lyapunov_v: float = 0.2, *,
                  u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the round's cohort: ``(device_idx (k,) int64, valid (k,) f32)``.

    ``valid[j] == 0`` marks a slot that could not be filled; callers mask
    its contribution and energy debit.  Eligible devices outrank
    ineligible ones, whose scores are -inf.
    """
    return cohort_from_scores(masked_scores(policy, state, rates, gen,
                                            round_cost_j, lyapunov_v, u=u), k)
