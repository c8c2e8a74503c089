"""Observability of the port (``repro_torch.obs``) against the reference's
``repro.obs``, as ``tests/test_obs.py`` holds the reference:

* sinks: records stamped with the schema, each passing the reference's
  ``validate_record``; the JSONL stream flushed per record; the console
  line the reference's;
* taps: one record a round, in round order, with true indices under
  ``every``, equal to the history (the simulator, with and without a
  fleet) or to the metrics the round returns (``make_fl_round`` in int and
  rsag, with and without a fleet);
* a tapped run computes what an untapped one does: parameters, fleet and
  history equal bit for bit (that an untapped fleet loop makes no
  synchronizing call is checked on the card, ``chip_smoke.py``);
* spans: a profiled cohort fleet round holds every ``wire/*`` phase its
  format runs, every ``fleet/*`` phase and both ``fl/*`` phases.
"""
import dataclasses
import io
import json
import time

import numpy as np
import pytest
import torch

from repro.obs import sinks as jsinks
from repro.obs import tap as jtap
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config
from repro_torch.core.fl import FLSimulator, make_fl_round
from repro_torch.data.pipeline import make_federated_digits
from repro_torch.data.synthetic import digit_dataset
from repro_torch.device import make_generator
from repro_torch.models import build_model
from repro_torch.obs import sinks, tap, trace
from repro_torch.population import fleet as tfleet

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(fleet_size=0):
    cfg = get_config("mnist_cnn")
    cfg = dataclasses.replace(
        cfg,
        fl=dataclasses.replace(cfg.fl, devices_per_round=4, local_iters=2,
                               learning_rate=0.05),
        train=dataclasses.replace(cfg.train, global_batch=16),
        fleet=dataclasses.replace(cfg.fleet, size=fleet_size))
    model = build_model(cfg)
    store = make_federated_digits(0, num_samples=300, num_clients=8,
                                  device="cpu")
    return model, FLSimulator(model, cfg, store, device="cpu")


def _params(model):
    return convert.flatten_params(model.init(1, device="cpu"))


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_make_record_takes_tensors_and_passes_the_references_check():
    rec = sinks.make_record("fl_round", 3, {
        "loss": torch.tensor(0.5), "selected": torch.arange(4),
        "nested": {"a": torch.tensor(1.0, dtype=torch.bfloat16),
                   "b": np.float32(2.0)},
        "round": 99})
    assert (rec["v"], rec["kind"], rec["round"]) == (1, "fl_round", 3)
    assert rec["loss"] == 0.5 and rec["selected"] == [0, 1, 2, 3]
    assert rec["nested"] == {"a": 1.0, "b": 2.0}
    assert sinks.validate_record(rec) == [] == jsinks.validate_record(rec)
    assert json.loads(json.dumps(rec)) == rec
    assert sinks.SCHEMA_VERSION == jsinks.SCHEMA_VERSION


def test_validate_record_catches_what_the_references_catches():
    good = sinks.make_record("fl_round", 0, {"loss": 1.0})
    for mutate in (lambda r: r.update(v=2), lambda r: r.update(kind=7),
                   lambda r: r.update(round=-1), lambda r: r.update(round=True),
                   lambda r: r.update(loss=float("nan")),
                   lambda r: r.update(loss=object()),
                   lambda r: r.update(x={"y": [1.0, float("inf")]})):
        rec = dict(good)
        mutate(rec)
        assert sinks.validate_record(rec) == jsinks.validate_record(rec) != []
    assert sinks.validate_record([1]) == jsinks.validate_record([1])


def test_jsonl_sink_streams_valid_lines(tmp_path):
    sink = sinks.JsonlSink(str(tmp_path / "t"))
    for t in range(3):
        sink.emit(sinks.make_record("fl_round", t,
                                    {"loss": torch.tensor(0.1 * t)}))
        with open(sink.path) as f:      # flushed per record
            assert len(f.readlines()) == t + 1
    sink.close()
    sink.close()
    with open(sink.path) as f:
        lines = [json.loads(line) for line in f]
    assert [r["round"] for r in lines] == [0, 1, 2] and sink.emitted == 3
    assert all(jsinks.validate_record(r) == [] for r in lines)


def test_aggregating_and_multi_sinks():
    agg, rec = sinks.AggregatingSink(), sinks.RecordingSink()
    multi = sinks.MultiSink(agg, rec)
    for t in range(11):
        multi.emit(sinks.make_record("fl_round", t,
                                     {"loss": float(t), "tag": "x"}))
    multi.close()
    s = agg.summary()
    assert s["loss"]["n"] == 11 and s["loss"]["mean"] == pytest.approx(5.0)
    assert s["loss"]["p90"] == pytest.approx(9.0)
    assert "tag" not in s and "round" not in s
    assert len(rec.records) == 11 and rec.emit_times == sorted(rec.emit_times)


def test_console_sink_line_is_the_references():
    for payload in ({"loss": 0.25, "accuracy": 0.875, "survivors": 3},
                    {"loss": 1.5, "accuracy": 0.1},
                    {"latency_s": 0.0123, "tokens_per_s": 812, "ok": True}):
        rec = sinks.make_record("fl_round", 12, payload)
        assert sinks.ConsoleSink().format(rec) == jsinks.ConsoleSink().format(rec)
    a, b = io.StringIO(), io.StringIO()
    for t in range(5):
        rec = sinks.make_record("fl_round", t, {"loss": 1.0, "accuracy": 0.5})
        sinks.ConsoleSink(log_every=2, stream=a).emit(rec)
        jsinks.ConsoleSink(log_every=2, stream=b).emit(rec)
    assert a.getvalue() == b.getvalue() and a.getvalue().count("round") == 3


def test_scan_and_step_taps_keep_true_indices():
    s, j = sinks.RecordingSink(), jsinks.RecordingSink()
    ts = tap.scan_sink_tap(s, start_round=4, every=2)
    js = jtap.scan_sink_tap(j, start_round=4, every=2)
    for _ in range(5):
        ts({"loss": torch.tensor(0.0)})
        js({"loss": np.float32(0.0)})
    assert [r["round"] for r in s.records] == [4, 6, 8] == \
        [r["round"] for r in j.records]
    s = sinks.RecordingSink()
    st = tap.shard0_sink_tap(s, kind="train_step", every=2)
    for r in (4, 3, 2, 6):
        st({"loss": torch.tensor(float(r))}, r)
    assert [r["round"] for r in s.records] == [4, 2, 6]
    assert [r["loss"] for r in s.records] == [4.0, 2.0, 6.0]


def test_deferred_tap_hands_on_in_call_order():
    got = []
    d = tap.DeferredTap(lambda tel, *a: got.append((tel["x"], a)))
    d({"x": 1}, 7)
    d({"x": torch.tensor(2)})
    d.flush()
    assert got[0] == (1, (7,)) and int(got[1][0]) == 2 and got[1][1] == ()


# ---------------------------------------------------------------------------
# the simulator's taps
# ---------------------------------------------------------------------------

def test_fleet_tap_records_equal_the_history_and_change_nothing():
    """With a 64-device fleet: one record a round, in order, while the
    call runs; each passes the reference's check and equals the history;
    parameters, fleet and history equal an untapped run's bit for bit."""
    model, sim = _sim(fleet_size=64)
    params, fleet0 = _params(model), sim.fleet_state
    p_off, h_off = sim.run_rounds(params, 3, 2)
    fleet_off, sim.fleet_state = sim.fleet_state, fleet0
    rec = sinks.RecordingSink()
    t0 = time.perf_counter()
    p_on, h_on = sim.run_rounds(params, 3, 2, tap=tap.scan_sink_tap(rec))
    t1 = time.perf_counter()
    assert all(t0 < te < t1 for te in rec.emit_times)
    assert h_on == h_off and torch.equal(p_on, p_off)
    assert all(torch.equal(a, b) for a, b in zip(sim.fleet_state, fleet_off))
    assert len(rec.records) == 3
    for r, h in zip(rec.records, h_on):
        assert jsinks.validate_record(r) == [] and r["kind"] == "fl_round"
        assert r["round"] == h["round"]
        for key in ("loss", "accuracy", "survivors", "tau_s",
                    "cohort_energy_j", "battery_total_j", "outage_rate",
                    "harvested_j", "power_q50_w"):
            assert r[key] == h[key], key
        valid = np.asarray(r["valid"]) > 0
        assert np.asarray(r["selected"])[valid].tolist() == h["selected"]


def test_tap_without_a_fleet_streams_the_history():
    model, sim = _sim(fleet_size=0)
    params = _params(model)
    p_off, h_off = sim.run_rounds(params, 3, 2)
    rec = sinks.RecordingSink()
    p_on, h_on = sim.run_rounds(params, 3, 2,
                                tap=tap.scan_sink_tap(rec, every=2))
    assert torch.equal(p_on, p_off)
    strip = lambda h: [{k: v for k, v in x.items() if k != "round_s"}
                       for x in h]
    assert strip(h_on) == strip(h_off)
    assert [r["round"] for r in rec.records] == [0, 2]
    for r in rec.records:
        h = h_on[r["round"]]
        assert jsinks.validate_record(r) == []
        assert (r["loss"], r["accuracy"], r["survivors"]) == \
            (h["loss"], h["accuracy"], h["survivors"])


def test_train_streams_to_its_sink_and_prints_the_references_line(capsys):
    model, sim = _sim(fleet_size=64)
    rec = sinks.RecordingSink()
    _, hist = sim.train(_params(model), 3, 2, log_every=2, sink=rec)
    assert [r["round"] for r in rec.records] == [0, 1, 2] and len(hist) == 3
    lines = capsys.readouterr().out.splitlines()
    want = [jsinks.ConsoleSink().format(jsinks.make_record(
        "fl_round", h["round"], h)) for h in hist if h["round"] % 2 == 0]
    assert lines == want and lines[0].startswith("  round    0 loss=")


# ---------------------------------------------------------------------------
# the cohort round's tap and the spans
# ---------------------------------------------------------------------------

def _cohort(collective, fleet, tapped=None, C=4, I=2, micro=4):
    over = (f"fl.local_iters={I}", f"train.global_batch={C * I * micro}",
            "channel.error_prob=0.3")
    if fleet:
        over += ("fleet.size=1000", "fleet.selection=rate_aware",
                 "power.policy=fbl_target")
    cfg = apply_overrides(get_config("mnist_cnn"), over)
    model = build_model(cfg)
    fn = make_fl_round(model, cfg, (C,), collective=collective,
                       device="cpu", tap=tapped)
    data = digit_dataset(make_generator(5, CPU), C * I * micro)
    batch = {"images": data["images"], "labels": data["labels"]}
    state = tfleet.init_fleet(3, cfg, device="cpu") if fleet else None
    return model, cfg, fn, batch, state


def _run_cohort(fn, model, batch, state, steps, **kw):
    params = _params(model)
    gen = make_generator(7, CPU)
    out = []
    for s in steps:
        extra = {"step": s} if kw.get("tapped") else {}
        if state is not None:
            params, m, state = fn(params, batch, gen, state, **extra)
        else:
            params, m = fn(params, batch, gen, **extra)
        out.append(m)
    return params, state, out


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("collective", ["int", "rsag"])
def test_cohort_round_tap_records_equal_its_metrics(collective, fleet):
    rec = sinks.RecordingSink()
    model, _, fn_on, batch, state = _cohort(
        collective, fleet, tap.shard0_sink_tap(rec, kind="train_step"))
    p_on, f_on, m_on = _run_cohort(fn_on, model, batch, state, (5, 6),
                                   tapped=True)
    _, _, fn_off, _, _ = _cohort(collective, fleet)
    p_off, f_off, m_off = _run_cohort(fn_off, model, batch, state, (5, 6))
    assert torch.equal(p_on, p_off)
    if fleet:
        assert all(torch.equal(a, b) for a, b in zip(f_on, f_off))
    assert [r["round"] for r in rec.records] == [5, 6]
    for r, m in zip(rec.records, m_off):
        assert jsinks.validate_record(r) == [] and r["kind"] == "train_step"
        assert {k: v for k, v in r.items() if k not in ("v", "kind", "round")} \
            == sinks.to_jsonable(m)
        assert ("battery_q50_j" in r) == fleet
    with pytest.raises(ValueError, match="step"):
        fn_on(_params(model), batch, make_generator(7, CPU),
              *((state,) if fleet else ()))


#: the wire phases each format runs (as the reference's aggregate spans them)
WIRE_SPANS = {"int": ("wire/psum", "wire/quantize_pack", "wire/unpack_dequant"),
              "rsag": ("wire/psum", "wire/quantize_pack", "wire/reduce_scatter",
                       "wire/all_gather", "wire/unpack_dequant")}


@pytest.mark.parametrize("collective", sorted(WIRE_SPANS))
def test_a_profiled_fleet_round_holds_every_phase(collective):
    model, _, fn, batch, state = _cohort(collective, True)
    params = _params(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(params, batch, make_generator(7, CPU), state)
    names = {e.key for e in prof.key_averages()}
    want = set(WIRE_SPANS[collective]) | set(trace.FLEET_PHASES) | \
        set(trace.FL_PHASES)
    assert want <= names, sorted(want - names)
    assert not (set(trace.WIRE_PHASES) - set(WIRE_SPANS[collective])) & names
