"""Per-round telemetry of the cohort round — the fleet-free part of
``repro.population.telemetry``.  The fleet keys come with the fleet.

``make_fl_round``'s metrics dict carries the loss and survivors as 0-dim
tensors on the round's device (reading one waits for the round) and the
wire accounting as Python floats fixed by the plan.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import aggregation as agg


def wire_phase_split(plan: agg.WirePlan) -> Dict[str, float]:
    """The collective's per-phase wire bits/param: {"psum": b} for the
    one-shot modes, {"ring_hops": b} for the ring, rsag's
    {"reduce_scatter", "all_gather"}.  Values sum to ``plan.wire_bits``."""
    return agg.wire_phase_bits_per_param(plan.mode, plan.quant,
                                         plan.axis_sizes)


def distributed_metrics(plan: agg.WirePlan, *, loss: torch.Tensor,
                        survivors: torch.Tensor) -> Dict[str, Any]:
    """The cohort round's metrics dict."""
    return {
        "loss": loss,
        "survivors": survivors,
        "wire_bits_per_param": float(plan.wire_bits),
        "wire_phase_bits_per_param": wire_phase_split(plan),
    }
