"""The port's flight recorder (``ba_tpu_torch/obs/flight.py``: run scopes,
the run id's precedence, ``FlightLog`` / ``assemble_flight`` /
``emit_flight_summary``), ``obs.trace.inject_scope`` and ``timed_span``,
and ``pipeline_sweep``'s run scope, flight spans and health sampling,
against the JAX package's on the CPU."""

import json

import numpy as np
import pytest

from ba_tpu.obs import flight as j_flight
from ba_tpu_torch import obs
from ba_tpu_torch.core import rng
from ba_tpu_torch.obs import flight
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel.sweep import make_sweep_state
from ba_tpu_torch.utils import metrics

TRACEPARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


@pytest.fixture()
def sink(tmp_path):
    path = tmp_path / "flight.jsonl"
    metrics.configure(str(path))
    yield path
    metrics.configure(None)


def _records(path, event=None):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return [r for r in recs if event is None or r.get("event") == event]


def test_run_scopes_nest_and_restore():
    assert metrics.active_run_id() is None
    with flight.run_scope("outer") as a:
        assert (a.run_id, a.owner) == ("outer", True)
        with flight.run_scope("inner") as b:
            assert (b.run_id, b.owner) == ("outer", False)
            assert flight.resolve_run_id("m", inherited="ckpt-id") == "outer"
            assert flight.resolve_run_id("m", run_id="pinned") == "pinned"
        assert metrics.active_run_id() == "outer"
    assert metrics.active_run_id() is None
    with pytest.raises(RuntimeError), flight.run_scope("x"):
        raise RuntimeError("boom")
    assert metrics.active_run_id() is None


@pytest.mark.parametrize("inherited", [None, "ckpt-run", "bad id!"])
def test_run_id_precedence_matches_the_reference(inherited):
    material = ("supervised", "ab" * 32, 12)
    want = j_flight.resolve_run_id(*material, inherited=inherited)
    assert flight.resolve_run_id(*material, inherited=inherited) == want
    assert flight.resolve_run_id(inherited=inherited,
                                 material_fn=lambda: material) == want
    with flight.run_scope("scoped"), j_flight.run_scope("scoped"):
        assert flight.resolve_run_id(*material, inherited=inherited) == "scoped" == \
            j_flight.resolve_run_id(*material, inherited=inherited)
    with pytest.raises(ValueError):
        flight.resolve_run_id(run_id="no spaces allowed")


STREAM = [
    {"event": "clock_anchor", "pid": 1},
    {"event": "flight_span", "run_id": "r1", "dispatch": 0, "lo": 0, "hi": 2, "latency_s": 0.5,
     "lag_s": 0.1, "ts": 1.0},
    {"event": "flight_span", "run_id": "r1", "dispatch": 1, "lo": 2, "hi": 4, "latency_s": 0.7,
     "lag_s": 0.2, "ts": 2.0},
    {"event": "scenario_checkpoint", "run_id": "r1", "round": 4, "path": "c_4.npz",
     "bytes": 10, "shard_layout": {"data": 1}, "ts": 2.5},
    {"event": "fault_injected", "run_id": "r1", "plan": "p", "kind": "fatal",
     "phase": "dispatch", "round": 4, "ts": 3.0},
    {"event": "recovery", "run_id": "r1", "fault": "fatal", "action": "resume", "attempt": 1,
     "from_round": 4, "lost_rounds": 0, "error": "InjectedFatal: x", "ts": 3.1},
    {"event": "flight_span", "run_id": "r1", "dispatch": 0, "lo": 4, "hi": 6, "latency_s": 0.4,
     "lag_s": 0.1, "ts": 4.0},
    {"event": "flight_span", "run_id": "r2", "dispatch": 0, "lo": 0, "hi": 8, "ts": 5.0},
    {"event": "health_snapshot", "run_id": "r1", "dispatch": 2, "ts": 4.5},
    {"event": "metrics_snapshot", "run_id": "r1", "metrics": {"pipeline_shards": {"value": 2}}},
]


@pytest.mark.parametrize("run_id", [None, "r1", "r2", "absent"])
def test_assemble_flight_matches_the_reference(tmp_path, run_id):
    path = tmp_path / "stream.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in STREAM) + '{"torn": ')
    got = flight.assemble_flight(str(path), run_id=run_id)
    assert got == j_flight.assemble_flight(str(path), run_id=run_id)
    if run_id == "r2":
        assert got["run_id"] == "r2" and got["windows"] == 1
    elif run_id in (None, "r1"):  # None: the last run the file names
        assert got["run_id"] == "r1" and got["rounds"] == [0, 6] and got["contiguous"] and got["windows"] == 3
        assert [e["kind"] for e in got["timeline"]] == [
            "dispatch_window", "dispatch_window", "checkpoint", "fault", "recovery",
            "dispatch_window"]
    else:
        assert got is None


def test_emit_flight_summary_appends_to_the_sink_only(tmp_path):
    metrics.configure(None)
    assert flight.emit_flight_summary(run_id="r1") is None  # no file to read back
    path = tmp_path / "s.jsonl"
    sink = metrics.configure(str(path))
    try:
        for rec in STREAM[1:4]:
            metrics.emit(dict(rec))
        summary = flight.emit_flight_summary(run_id="r1")
    finally:
        metrics.configure(None)
    assert summary["windows"] == 2 and sink.file_path() == str(path)
    assert _records(path, "flight_summary") == [json.loads(json.dumps(summary))]


def test_inject_scope_adopts_a_child_of_the_traceparent(sink):
    with obs.trace.inject_scope(None) as ctx:
        assert ctx is None
    with obs.trace.inject_scope("not-a-traceparent") as ctx:
        assert ctx is None
    with obs.trace.inject_scope(TRACEPARENT, mark="campaign") as ctx:
        assert ctx[0] == "ab" * 16 and ctx[2] == "cd" * 8 and ctx[1] != "cd" * 8
        with obs.trace.inject_scope("00-" + "11" * 16 + "-" + "22" * 8 + "-01") as inner:
            assert inner == ctx  # an active context wins
    assert obs.trace.current() is None
    mark, = _records(sink, "trace_span")
    assert (mark["name"], mark["trace_id"], mark["parent_id"], mark["dur_s"]) == (
        "campaign", "ab" * 16, "cd" * 8, 0.0)


def test_timed_span_feeds_the_histogram_and_the_tracer():
    reg = MetricsRegistry()
    hist = reg.histogram("lat_s")
    tracer = obs.trace.configure(True)
    try:
        with obs.timed_span("retire", hist, dispatch=3) as box:
            assert box.elapsed_s is None
        with obs.timed_span("plain") as bare:
            pass
        events = tracer.chrome_events()
    finally:
        obs.trace.configure(None)
    assert box.elapsed_s > 0 and bare.elapsed_s > 0
    assert hist.snapshot()["count"] == 1
    assert [e["name"] for e in events] == ["retire", "plain"]
    assert events[0]["args"] == {"dispatch": 3}
    with obs.timed_span("off") as box:  # the tracer off: the clock still runs
        pass
    assert box.elapsed_s >= 0


def test_pipeline_sweep_runs_in_its_scope_and_records_its_flight(sink):
    """One ``flight_span`` a retired window, the scope's id on every
    record and in ``stats``, one ``flight_summary`` from the owner, a
    health sample every two dispatches, and the ``pipeline_*``
    instruments fed once a batch."""
    reg = obs.default_registry()
    before = reg.counter("pipeline_dispatches_total").value
    state = make_sweep_state(rng.key(1, device="cpu"), 8, 8)
    out = tp.pipeline_sweep(rng.key(2, device="cpu"), state, 12, rounds_per_dispatch=2,
                            health_every=2, retire_timeout_s=30.0, device="cpu",
                            traceparent=TRACEPARENT)
    rid = out["stats"]["run_id"]
    spans = _records(sink, "flight_span")
    assert [(s["lo"], s["hi"]) for s in spans] == [(i, i + 2) for i in range(0, 12, 2)]
    assert {s["run_id"] for s in spans} == {rid}
    assert {s["trace_id"] for s in spans} == {"ab" * 16}
    health = _records(sink, "health_snapshot")
    assert len(health) == out["stats"]["health_samples"] == 3
    assert health[-1]["watchdog_timeout_s"] == 30.0
    assert np.isfinite(health[-1]["watchdog_margin_s"])
    summary, = _records(sink, "flight_summary")
    assert (summary["run_id"], summary["rounds"], summary["windows"]) == (rid, [0, 12], 6)
    assert reg.counter("pipeline_dispatches_total").value - before == 6
    assert metrics.active_run_id() is None
    with flight.run_scope("outer-run"):
        inner = tp.pipeline_sweep(rng.key(2, device="cpu"),
                                  make_sweep_state(rng.key(1, device="cpu"), 8, 8),
                                  4, device="cpu")
    assert inner["stats"]["run_id"] == "outer-run"
    assert len(_records(sink, "flight_summary")) == 1  # an inheriting scope emits none
