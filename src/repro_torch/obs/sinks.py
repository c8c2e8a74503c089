"""Pluggable metric sinks: where streamed telemetry records land (the
port's copy of ``repro.obs.sinks``, same schema).

Every record is one flat-ish JSON-able dict stamped with the schema
version (``v`` = :data:`SCHEMA_VERSION`), a ``kind`` discriminator and a
``round`` (or step) index — see :mod:`repro_torch.obs` for the schema.
Sinks are plain host-side objects with two methods::

    sink.emit(record)   # one record, already JSON-able
    sink.close()        # flush/release (idempotent)

* :class:`JsonlSink` — append one versioned JSON line per record to
  ``<dir>/<filename>`` (the trainer's ``--telemetry-dir``), flushed per
  record so a ``tail -f`` sees rounds while the run goes on;
* :class:`AggregatingSink` — running mean / percentiles over every
  numeric scalar key (energy, outage, wire bits, wall-clock, ...);
* :class:`ConsoleSink` — the one round formatter (``FLSimulator.train``
  prints through it);
* :class:`MultiSink` — fan one record out to several sinks;
* :class:`RecordingSink` — keeps records (plus emit wall-times) in memory,
  for tests.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Protocol

import numpy as np
import torch

#: version stamped into every record as ``"v"`` — bump on schema breaks
SCHEMA_VERSION = 1

#: keys every record carries regardless of kind
REQUIRED_KEYS = ("v", "kind", "round")


class MetricsSink(Protocol):
    """The sink protocol: host-side, takes JSON-able record dicts."""

    def emit(self, record: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


def to_jsonable(value: Any) -> Any:
    """numpy scalars and torch tensors (read to the host) -> python
    numbers, arrays -> lists, dicts recurse."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        value = value.cpu().numpy()
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


def make_record(kind: str, round_index: int,
                payload: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp a telemetry payload into one versioned record."""
    rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "kind": str(kind),
                           "round": int(round_index)}
    for k, v in payload.items():
        if k not in REQUIRED_KEYS:
            rec[str(k)] = to_jsonable(v)
    return rec


def _jsonable_errors(prefix: str, value: Any, out: List[str]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _jsonable_errors(f"{prefix}.{k}", v, out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _jsonable_errors(f"{prefix}[{i}]", v, out)
    elif isinstance(value, float):
        if not np.isfinite(value):
            out.append(f"{prefix}: non-finite float {value!r}")
    elif not isinstance(value, (str, bool, int)) and value is not None:
        out.append(f"{prefix}: non-JSON-able type {type(value).__name__}")


def validate_record(record: Any) -> List[str]:
    """Schema check; returns a list of problems (empty = valid).

    Valid records are dicts with ``v == SCHEMA_VERSION``, a string
    ``kind``, an int ``round`` >= 0, and every payload value a finite
    number, string, bool, None, or (nested) list/dict thereof.
    """
    problems: List[str] = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, not dict"]
    if record.get("v") != SCHEMA_VERSION:
        problems.append(f"v={record.get('v')!r} != {SCHEMA_VERSION}")
    if not isinstance(record.get("kind"), str):
        problems.append(f"kind={record.get('kind')!r} is not a string")
    rnd = record.get("round")
    if not isinstance(rnd, int) or isinstance(rnd, bool) or rnd < 0:
        problems.append(f"round={rnd!r} is not a non-negative int")
    for k, v in record.items():
        if k not in REQUIRED_KEYS:
            _jsonable_errors(k, v, problems)
    return problems


class JsonlSink:
    """Append one versioned JSON line per record to ``dir/filename``.

    The file is opened lazily on the first emit and flushed per record,
    so the stream is visible (e.g. to ``tail -f``) while the producing
    run goes on.
    """

    def __init__(self, directory: str, filename: str = "telemetry.jsonl"):
        self.path = os.path.join(directory, filename)
        self._dir = directory
        self._fh = None
        self.emitted = 0

    def emit(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            os.makedirs(self._dir, exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        self.emitted += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class AggregatingSink:
    """Running mean / percentiles over every numeric scalar record key.

    ``summary()`` returns ``{key: {"n", "mean", "p10", "p50", "p90"}}``
    (percentiles configurable) — the cheap post-run rollup of a streamed
    run (mean energy, outage tail, wire bits, wall-clock, ...).
    """

    def __init__(self, percentiles: Iterable[float] = (10.0, 50.0, 90.0)):
        self.percentiles = tuple(percentiles)
        self._values: Dict[str, List[float]] = {}
        self.emitted = 0

    def emit(self, record: Dict[str, Any]) -> None:
        self.emitted += 1
        for k, v in record.items():
            if k in REQUIRED_KEYS:
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._values.setdefault(k, []).append(float(v))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for k, vals in self._values.items():
            arr = np.asarray(vals, np.float64)
            stats = {"n": float(arr.size), "mean": float(arr.mean())}
            for p, q in zip(self.percentiles,
                            np.percentile(arr, self.percentiles)):
                stats[f"p{p:g}"] = float(q)
            out[k] = stats
        return out

    def close(self) -> None:
        pass


class ConsoleSink:
    """The round-line formatter (interactive and streamed share it).

    Prints every ``log_every``-th round as the reference's
    ``FLSimulator.train`` line::

        round  120 loss=0.6931 acc=0.5000 survivors=4

    Records without loss/accuracy (e.g. serve decode steps) fall back to
    a compact ``key=value`` rendering of their scalar payload.
    """

    def __init__(self, log_every: int = 1, stream=None):
        self.log_every = max(int(log_every), 1)
        self.stream = stream if stream is not None else sys.stdout
        self.emitted = 0

    def format(self, record: Dict[str, Any]) -> str:
        r = record.get("round", 0)
        if "loss" in record and "accuracy" in record:
            line = (f"  round {r:4d} loss={record['loss']:.4f} "
                    f"acc={record['accuracy']:.4f}")
            if "survivors" in record:
                line += f" survivors={int(record['survivors'])}"
            return line
        scalars = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in record.items()
                   if k not in REQUIRED_KEYS
                   and isinstance(v, (int, float)) and not isinstance(v, bool)]
        return f"  {record.get('kind', 'record')} {r:4d} " + " ".join(scalars)

    def emit(self, record: Dict[str, Any]) -> None:
        self.emitted += 1
        if record.get("round", 0) % self.log_every == 0:
            print(self.format(record), file=self.stream)

    def close(self) -> None:
        pass


class MultiSink:
    """Fan one record out to several sinks (emit/close forwarded)."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = list(sinks)

    def emit(self, record: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class RecordingSink:
    """In-memory sink for tests: keeps records plus per-emit wall-times
    (``time.perf_counter()``) so a test can show records arrived while the
    producing call was still running."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self.emit_times: List[float] = []

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(record)
        self.emit_times.append(time.perf_counter())

    def close(self) -> None:
        pass
