"""Streaming round taps: the host side of per-round telemetry.

A tap is a host callable that the round loops call once a round:
``FLSimulator.run_rounds(..., tap=)`` calls ``tap(telemetry)`` and the
cohort round of ``make_fl_round(..., tap=)`` calls ``tap(metrics, step)``,
the round's absolute step being the ``step`` its caller passes.  The
adapters turn a :class:`~repro_torch.obs.sinks.MetricsSink` into such a
callable: each call makes one versioned record (``sinks.make_record``) and
emits it.

The reference ships the telemetry out of its jitted scan or ``shard_map``
with ``io_callback`` (``emit_in_scan``, ``emit_on_shard0``); the port runs
eagerly, so it has no traced side and those two have no counterpart.  One
device is one shard, so :func:`shard0_sink_tap` has no shard to filter.

Reading a round's device tensors waits for the round.  :class:`DeferredTap`
avoids that: it copies each round's CUDA tensors into pinned host memory
without blocking, behind a CUDA event, and hands a round on once its event
has completed, in round order, while later rounds queue; ``flush`` waits
for the rest.  The copies only read the round's outputs, so a tapped run
computes what an untapped one does.  ``tap=None`` adds nothing to a round.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

import torch

from repro_torch.obs import sinks as _sinks

#: a host callable receiving one round's telemetry dict
ScanTap = Callable[[Dict[str, Any]], None]
#: a host callable receiving (metrics dict, round index)
StepTap = Callable[[Dict[str, Any], int], None]


def scan_sink_tap(sink: "_sinks.MetricsSink", *, kind: str = "fl_round",
                  start_round: int = 0, every: int = 1) -> ScanTap:
    """Host adapter: telemetry dict -> versioned record -> ``sink.emit``.

    Rounds are numbered ``start_round, start_round+1, ...`` in call order
    (the round loops call in round order).  ``every`` keeps only every N-th
    round's record; the index still advances every call, so kept records
    carry their true round.
    """
    counter = [start_round]

    def tap(tel: Dict[str, Any]) -> None:
        r = counter[0]
        counter[0] += 1
        if (r - start_round) % every:
            return
        sink.emit(_sinks.make_record(kind, r, tel))

    return tap


def shard0_sink_tap(sink: "_sinks.MetricsSink", *, kind: str = "fl_round",
                    every: int = 1) -> StepTap:
    """Host adapter for the cohort round: record the metrics with the
    round's step stamp (so a resumed run's appended stream stays monotonic
    in true step index).  ``every`` keeps steps whose absolute index is a
    multiple of ``every``."""

    def tap(tel: Dict[str, Any], round_index: int) -> None:
        r = int(round_index)
        if r % every:
            return
        sink.emit(_sinks.make_record(kind, r, tel))

    return tap


def _host_copy(value: Any) -> Any:
    """``value`` with each CUDA tensor replaced by a pinned host tensor its
    contents are copied into without blocking (dicts recurse)."""
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        host.copy_(value.detach(), non_blocking=True)
        return host
    return value


def _has_cuda(value: Any) -> bool:
    if isinstance(value, dict):
        return any(_has_cuda(v) for v in value.values())
    return isinstance(value, torch.Tensor) and value.device.type == "cuda"


class DeferredTap:
    """A tap that never makes the caller wait for the device.

    Each call copies the telemetry's CUDA tensors to pinned host memory on
    the current stream (``non_blocking``) and records a CUDA event; the
    wrapped ``tap`` gets the host copies, with the call's other arguments,
    once the event has completed: checked at every call, in call order.
    :meth:`flush` waits for the events still pending and hands their rounds
    on.  Telemetry without CUDA tensors goes on at once (in order)."""

    def __init__(self, tap: Callable[..., None]):
        self.tap = tap
        self._pending: Deque[Tuple[Any, Tuple[Any, ...],
                                   Optional[torch.cuda.Event]]] = deque()

    def __call__(self, tel: Dict[str, Any], *args: Any) -> None:
        event = None
        if _has_cuda(tel):
            tel = _host_copy(tel)
            event = torch.cuda.Event()
            event.record()
        self._pending.append((tel, args, event))
        self.poll()

    def poll(self) -> None:
        """Hand on every leading round whose copies have completed."""
        while self._pending:
            tel, args, event = self._pending[0]
            if event is not None and not event.query():
                return
            self._pending.popleft()
            self.tap(tel, *args)

    def flush(self) -> None:
        """Wait for the pending rounds' copies and hand them on."""
        while self._pending:
            tel, args, event = self._pending.popleft()
            if event is not None:
                event.synchronize()
            self.tap(tel, *args)
