"""Phase-attributed tracing: named spans over the wire, fleet and FL
phases (the reference's ``repro.obs.trace``, same names).

:func:`phase_span` and :func:`host_span` are both
``torch.profiler.record_function``: under ``torch.profiler.profile`` each
span is a named range on the host timeline, and the kernels launched
inside it sit under it in the trace.  Nothing here calls NVTX: a CPU build
of PyTorch raises on ``torch.cuda.nvtx``; NVTX ranges come from the
profiling side (``torch.autograd.profiler.emit_nvtx``), which turns these
ranges into NVTX ones.  Outside a profile a span costs one host call on
enter and one on exit, so spans sit at phase level only, never one a leaf
or a layer.

Span names are hierarchical ``area/phase`` strings: the wire phases of
:data:`WIRE_PHASES` (``core/aggregation.py``), the fleet state machine's
:data:`FLEET_PHASES` (``population/fleet.py`` ``round_update``) and the
round's :data:`FL_PHASES` (``core/fl.py``).
"""
from __future__ import annotations

import torch

#: the wire phases of one collective round, in execution order
WIRE_PHASES = (
    "wire/quantize_pack",    # quantize -> pack -> chunk front-end
    "wire/psum",             # one-shot all-reduce (paper/int/packed)
    "wire/ring_hops",        # the ring's hop loop
    "wire/reduce_scatter",   # rsag scatter phase
    "wire/all_gather",       # rsag gather phase
    "wire/unpack_dequant",   # unpack + dequantize back-end
)

#: the fleet round_update state-machine phases, in execution order
FLEET_PHASES = (
    "fleet/advance_channel",
    "fleet/power_assign",
    "fleet/rates_cost",
    "fleet/select",
    "fleet/drop_realize",
    "fleet/energy_ledger",
)

#: the FL round phases outside the wire/fleet areas
FL_PHASES = ("fl/local_steps", "fl/apply")


def phase_span(name: str) -> torch.profiler.record_function:
    """A span over one phase of a round (a context manager)."""
    return torch.profiler.record_function(name)


def host_span(name: str) -> torch.profiler.record_function:
    """A span over a host-side section (a context manager); the same
    profiler range as :func:`phase_span`, kept for the reference's API."""
    return torch.profiler.record_function(name)
