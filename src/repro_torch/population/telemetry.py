"""Structured per-round telemetry — the one place round metrics are built.

Two consumers share the schema:

* the cohort round (``core.fl.make_fl_round``): a flat metrics dict per
  round, the loss and survivors as 0-dim tensors on the round's device
  (reading one waits for the round), the wire accounting as Python floats
  fixed by the plan (``wire_bits_per_param`` and its per-phase split
  ``wire_phase_bits_per_param``), and with a fleet the fleet keys;
* the fleet simulator (``FLSimulator.run_rounds``): one dict of device
  tensors a round, stacked and copied to the host once at the end by
  :func:`expand_history` into the per-round history dicts of ``train``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation as agg

#: battery (and assigned-power) percentiles reported each round
BATTERY_QUANTILES = (10.0, 50.0, 90.0)


def wire_phase_split(plan: agg.WirePlan) -> Dict[str, float]:
    """The collective's per-phase wire bits/param: {"psum": b} for the
    one-shot modes, {"ring_hops": b} for the ring, rsag's
    {"reduce_scatter", "all_gather"}.  Values sum to ``plan.wire_bits``."""
    return agg.wire_phase_bits_per_param(plan.mode, plan.quant,
                                         plan.axis_sizes)


def distributed_metrics(plan: agg.WirePlan, *, loss: torch.Tensor,
                        survivors: torch.Tensor,
                        fleet: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, Any]:
    """The cohort round's metrics dict."""
    m: Dict[str, Any] = {
        "loss": loss,
        "survivors": survivors,
        "wire_bits_per_param": float(plan.wire_bits),
        "wire_phase_bits_per_param": wire_phase_split(plan),
    }
    if fleet is not None:
        m.update(fleet)
    return m


FLEET_METRIC_KEYS = ("cohort_energy_j", "energy_budget_j", "selected_valid",
                     "battery_total_j", "battery_q10_j", "battery_q50_j",
                     "battery_q90_j", "power_q10_w", "power_q50_w",
                     "power_q90_w", "outage_rate", "outage_target",
                     "harvested_j")


def distributed_metrics_structure(plan: agg.WirePlan,
                                  with_fleet: bool) -> Dict[str, Any]:
    """A template with the exact key structure :func:`distributed_metrics`
    returns."""
    m: Dict[str, Any] = {
        "loss": 0.0, "survivors": 0.0, "wire_bits_per_param": 0.0,
        "wire_phase_bits_per_param": {k: 0.0 for k in wire_phase_split(plan)},
    }
    if with_fleet:
        m.update({k: 0.0 for k in FLEET_METRIC_KEYS})
    return m


def percentiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """The ``qs`` percentiles of a 1-D tensor by linear interpolation
    between the order statistics (``jnp.percentile``'s default): one sort
    on the tensor's device, positions fixed by its length (no host read)."""
    s = torch.sort(x).values
    n = x.shape[0]
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        out.append(s[lo] + (s[hi] - s[lo]) * frac)
    return torch.stack(out)


def fleet_round_metrics(*, battery_j: torch.Tensor, valid: torch.Tensor,
                        charge_j: torch.Tensor, power_w: torch.Tensor,
                        outage_sel: torch.Tensor, cost_sel: torch.Tensor,
                        harvest_j: torch.Tensor,
                        error_prob: float) -> Dict[str, torch.Tensor]:
    """The fleet extras of one round (0-dim tensors; both runtimes):
    battery and assigned-power quantiles over the whole fleet, the round's
    energy budget (Σ assigned cohort cost) beside the realized debit
    (``cohort_energy_j``, lower where batteries clip at empty), the
    realized cohort outage rate against the configured FBL target, and
    the realized harvest."""
    q = percentiles(battery_j, BATTERY_QUANTILES)
    pq = percentiles(power_w, BATTERY_QUANTILES)
    n_valid = valid.sum()
    return {
        "cohort_energy_j": charge_j.sum(),
        "energy_budget_j": (valid * cost_sel).sum(),
        "selected_valid": n_valid,
        "battery_total_j": battery_j.sum(),
        "battery_q10_j": q[0], "battery_q50_j": q[1], "battery_q90_j": q[2],
        "power_q10_w": pq[0], "power_q50_w": pq[1], "power_q90_w": pq[2],
        "outage_rate": outage_sel.sum() / torch.clamp(n_valid, min=1.0),
        "outage_target": torch.full((), error_prob, dtype=torch.float32,
                                    device=valid.device),
        "harvested_j": harvest_j,
    }


def simulator_round_telemetry(*, loss: torch.Tensor, accuracy: torch.Tensor,
                              selected: torch.Tensor, valid: torch.Tensor,
                              lam: torch.Tensor, battery_j: torch.Tensor,
                              charge_j: torch.Tensor, tau_s: torch.Tensor,
                              power_w: torch.Tensor, outage_sel: torch.Tensor,
                              cost_sel: torch.Tensor, harvest_j: torch.Tensor,
                              error_prob: float) -> Dict[str, torch.Tensor]:
    """One round of fleet-simulator telemetry, device tensors."""
    tel = {
        "loss": loss, "accuracy": accuracy,
        "selected": selected,                     # (K,) device ids
        "valid": valid,                           # (K,) filled-slot mask
        "survivors": lam.sum(),
        "drops": valid.sum() - lam.sum(),         # realized drops
        "tau_s": tau_s,
    }
    tel.update(fleet_round_metrics(battery_j=battery_j, valid=valid,
                                   charge_j=charge_j, power_w=power_w,
                                   outage_sel=outage_sel, cost_sel=cost_sel,
                                   harvest_j=harvest_j,
                                   error_prob=error_prob))
    return tel


#: telemetry keys expanded to Python floats in the history dicts
_SCALAR_KEYS = ("loss", "survivors", "drops", "tau_s", "cohort_energy_j",
                "energy_budget_j", "selected_valid", "battery_total_j",
                "battery_q10_j", "battery_q50_j", "battery_q90_j",
                "power_q10_w", "power_q50_w", "power_q90_w", "outage_rate",
                "outage_target", "harvested_j")


def stack_rounds(tels: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-round telemetry dicts → one dict with a leading round axis."""
    return {k: torch.stack([t[k] for t in tels]) for k in tels[0]}


def expand_history(stacked: Dict[str, torch.Tensor], rounds: int,
                   start_round: int = 0) -> List[Dict[str, Any]]:
    """Stacked telemetry → the per-round history dicts of ``train``, the
    one copy to the host.

    Keeps the legacy keys (round/loss/accuracy/survivors/energy_j/tau_s),
    ``energy_j`` being the round's realized cohort energy (the battery
    debit), and adds the fleet extras and the valid ``selected`` ids."""
    host = {k: v.detach().cpu().numpy() for k, v in stacked.items()}
    history = []
    for t in range(rounds):
        h: Dict[str, Any] = {"round": start_round + t,
                             "accuracy": float(host["accuracy"][t]),
                             "energy_j": float(host["cohort_energy_j"][t])}
        for k in _SCALAR_KEYS:
            h[k] = float(host[k][t])
        h["survivors"] = int(h["survivors"])
        h["selected"] = host["selected"][t][
            host["valid"][t] > 0].astype(int).tolist()
        history.append(h)
    return history
