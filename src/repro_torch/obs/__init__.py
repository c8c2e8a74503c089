"""Observability: streaming round taps, pluggable sinks, phase spans (the
port of ``repro.obs``).

* :mod:`repro_torch.obs.tap` — host adapters that turn a sink into the
  per-round tap ``FLSimulator.run_rounds`` and ``make_fl_round`` call, and
  :class:`~repro_torch.obs.tap.DeferredTap`, which hands a round on once
  its device tensors have reached pinned host memory, so the round never
  waits.  The reference's traced side, ``emit_in_scan`` and
  ``emit_on_shard0`` (``io_callback`` inside a jitted scan or
  ``shard_map``), has no counterpart: the port runs eagerly and calls the
  tap itself.  ``tap=None`` adds nothing to a round.
* :mod:`repro_torch.obs.sinks` — where records land: ``JsonlSink`` (the
  trainer's ``--telemetry-dir`` stream), ``AggregatingSink``,
  ``ConsoleSink`` (the one round-line formatter), ``MultiSink``,
  ``RecordingSink`` (tests).
* :mod:`repro_torch.obs.trace` — ``phase_span`` / ``host_span``, profiler
  ranges named ``wire/*``, ``fleet/*`` and ``fl/*``.

Records follow the reference's schema, version ``sinks.SCHEMA_VERSION`` =
1: every record is one JSON object with ``v`` (1), ``kind`` (``"fl_round"``
from the simulator, ``"train_step"`` from the trainer's cohort round) and
``round`` (the round or step index, monotonic in a stream, resumed runs
included), then the payload:

* ``fl_round`` — the simulator's round telemetry: ``loss``, ``accuracy``,
  ``survivors``; with a fleet also ``selected`` (device ids), ``valid``
  (0/1 mask), ``drops``, ``tau_s`` (s), ``cohort_energy_j`` /
  ``energy_budget_j`` / ``harvested_j`` (J), ``selected_valid``,
  ``battery_total_j`` and ``battery_q{10,50,90}_j`` (J),
  ``power_q{10,50,90}_w`` (W), ``outage_rate`` / ``outage_target``;
* ``train_step`` — the cohort round's metrics dict: ``loss``,
  ``survivors``, ``wire_bits_per_param``, the nested
  ``wire_phase_bits_per_param``, and the fleet extras with a fleet.

``sinks.validate_record`` is the schema gate.
"""
from repro_torch.obs.sinks import (SCHEMA_VERSION, AggregatingSink,
                                   ConsoleSink, JsonlSink, MetricsSink,
                                   MultiSink, RecordingSink, make_record,
                                   to_jsonable, validate_record)
from repro_torch.obs.tap import DeferredTap, scan_sink_tap, shard0_sink_tap
from repro_torch.obs.trace import (FL_PHASES, FLEET_PHASES, WIRE_PHASES,
                                   host_span, phase_span)

__all__ = [
    "SCHEMA_VERSION", "AggregatingSink", "ConsoleSink", "JsonlSink",
    "MetricsSink", "MultiSink", "RecordingSink", "make_record",
    "to_jsonable", "validate_record",
    "DeferredTap", "scan_sink_tap", "shard0_sink_tap",
    "FL_PHASES", "FLEET_PHASES", "WIRE_PHASES", "host_span", "phase_span",
]
