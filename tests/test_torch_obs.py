"""The port's observability layer (``ba_tpu_torch/utils/metrics.py``,
``obs/registry.py``, ``obs/trace.py``, ``obs/health.py``) against the JAX
package's, on the CPU.

Held exactly: histogram buckets, ``delta_quantile``, snapshot records
(apart from times) and the Prometheus text for the same records; the
traceparent codec and context derivation; the sink's records and its
directory shards.  Without a configured sink nothing is written; the
health sampler's gauges come from a seeded run of the coalesced loop
(``coalesced_sweep``), whose ``pipeline_*`` instruments it reads.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from ba_tpu.obs import health as j_health
from ba_tpu.obs import registry as j_registry
from ba_tpu.obs import trace as j_trace
from ba_tpu.utils import metrics as j_metrics
from ba_tpu_torch import obs
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.obs import health, registry, trace
from ba_tpu_torch.parallel.pipeline import coalesced_sweep
from ba_tpu_torch.utils import metrics


def _values(seed, k=400):
    rs = np.random.default_rng(seed)
    return np.concatenate([rs.lognormal(-9, 3, k), [0.0, 1e-6, 2e-6, 1e9]]).tolist()


def _fill(mod, vals):
    reg = mod.MetricsRegistry()
    h = reg.histogram("lat_s")
    occ = reg.histogram("occ", base=1.0, n_buckets=16)
    c = reg.counter("events_total")
    g = reg.gauge("depth")
    for i, v in enumerate(vals):
        h.record(v)
        occ.record(i % 5)
        c.inc(i % 3)
    g.set(3.5)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_snapshot_and_prometheus_equal_reference(seed):
    vals = _values(seed)
    reg, jreg = _fill(registry, vals), _fill(j_registry, vals)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.prometheus_text() == jreg.prometheus_text()
    h, jh = reg.get("lat_s"), jreg.get("lat_s")
    assert h.peek()["counts"] == jh.peek()["counts"]
    then = h.peek()["counts"]
    for v in vals[:50]:
        h.record(v * 3)
        jh.record(v * 3)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for base in (None, then):
            got = registry.delta_quantile(h, base, h.peek()["counts"], q)
            want = j_registry.delta_quantile(jh, base, jh.peek()["counts"], q)
            assert got == want or (math.isinf(got) and math.isinf(want))
    assert registry.delta_quantile(h, h.peek()["counts"], h.peek()["counts"], 0.5) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_record_many_equals_the_reference_recording_each(seed):
    """The coalesced loop's batched ``record_many`` leaves a histogram as
    the JAX package's ``record`` of each value in turn does."""
    vals = _values(seed) + [float("inf"), float("nan")]
    reg, jreg = registry.MetricsRegistry(), j_registry.MetricsRegistry()
    for shape in ({}, {"base": 1.0, "n_buckets": 16}):
        h, jh = reg.histogram(f"h{len(shape)}", **shape), jreg.histogram(f"h{len(shape)}", **shape)
        h.record(5e-4)
        h.record_many(vals[:-1])
        h.record_many([])
        h.record_many(vals[-1:])
        for v in [5e-4] + vals:
            jh.record(v)
        got, want = h.peek(), jh.peek()
        assert got["counts"] == want["counts"] and got["count"] == want["count"]
        assert math.isnan(got["sum"]) and math.isnan(want["sum"])
        assert (got["min"], got["max"]) == (want["min"], want["max"])
        h2, jh2 = (r.histogram("finite", **shape) for r in (reg, jreg))
        h2.record_many(vals[:-2])
        for v in vals[:-2]:
            jh2.record(v)
        assert h2.peek() == jh2.peek()


def test_snapshot_records_equal_apart_from_times(tmp_path):
    vals = _values(7, 50)
    metrics.configure(str(tmp_path / "port.jsonl"))
    j_metrics.configure(str(tmp_path / "ref.jsonl"))
    try:
        _fill(registry, vals).emit_snapshot(config="x")
        _fill(j_registry, vals).emit_snapshot(config="x")
    finally:
        metrics.configure(None)
        j_metrics.configure(None)
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("port.jsonl", "ref.jsonl"))
    got.pop("ts"), want.pop("ts")
    assert got == want and got["event"] == "metrics_snapshot"


def test_registry_naming_rules():
    reg = registry.MetricsRegistry()
    for bad in ("per_shard_bytes", "queue_serve_depth"):
        with pytest.raises(ValueError):
            reg.counter(bad)
        with pytest.raises(ValueError):
            j_registry.MetricsRegistry().counter(bad)
    reg.counter("equivocation_observed")
    reg.gauge("plane_bytes_per_shard")
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    assert obs.default_registry() is registry.default_registry()


def test_traceparent_and_contexts_round_trip():
    for value in ("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01", " 00-" + "AB" * 16 + "-"
                  + "0f" * 8 + "-00 ", "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
                  "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01", "junk", None, 5):
        assert metrics.parse_traceparent(value) == j_metrics.parse_traceparent(value)
    tid, sid = metrics.new_trace_id(), metrics.new_span_id()
    tp = metrics.format_traceparent(tid, sid)
    assert tp == j_metrics.format_traceparent(tid, sid)
    assert metrics.parse_traceparent(tp) == (tid, sid)
    child = trace.new_context(tp)
    assert child[0] == tid and child[2] == sid and len(child[1]) == 16
    assert trace.new_context("bad")[2] is None
    root = trace.new_context()
    assert root[2] is None and len(root[0]) == 32
    assert trace.current() is None and trace.child_context()[2] is None
    with trace.scope(root):
        assert trace.current() == root
        assert trace.current_traceparent() == metrics.format_traceparent(root[0], root[1])
        kid = trace.child_context()
        assert kid[0] == root[0] and kid[2] == root[1]
        jkid = j_trace.child_context(root)
        assert jkid[0] == root[0] and jkid[2] == root[1]
        with trace.scope(None):
            assert trace.current() == root
    assert trace.current() is None


def test_sink_stamps_records_and_writes_shards(tmp_path):
    path = tmp_path / "m" / "out.jsonl"
    metrics.configure(str(path))
    try:
        ctx = trace.new_context()
        with trace.scope(ctx):
            metrics.emit({"event": "health_snapshot", "tag": "x"})
        prev = metrics.set_run_id("run-abc")
        metrics.emit({"event": "health_snapshot", "tag": "y"})
        metrics.set_run_id(prev)
        trace.emit_trace_span("serve_batch", ctx, 1.0, 0.5, slots=2)
    finally:
        metrics.configure(None)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r.get("tag", r["event"]) for r in recs] == ["x", "y", "trace_span"]
    assert all(r["v"] == metrics.SCHEMA_VERSION == j_metrics.SCHEMA_VERSION for r in recs)
    assert (recs[0]["trace_id"], recs[0]["span_id"]) == ctx[:2] and "parent_id" not in recs[0]
    assert recs[1]["run_id"] == "run-abc" and "trace_id" not in recs[1]
    assert recs[2]["dur_s"] == 0.5 and recs[2]["slots"] == 2
    shard_dir = str(tmp_path / "shards") + os.sep
    sink = metrics.configure(shard_dir)
    try:
        metrics.emit({"event": "health_snapshot", "tag": "z"})
        shard = sink.file_path()
    finally:
        metrics.configure(None)
    lines = [json.loads(line) for line in open(shard)]
    assert os.path.dirname(shard) + os.sep == shard_dir
    assert [r.get("tag", r["event"]) for r in lines] == ["clock_anchor", "z"]


def test_no_file_without_a_sink_and_no_buffer_without_a_tracer(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not metrics.default_sink().enabled
    metrics.emit({"event": "health_snapshot"})
    with obs.span("quiet"):
        obs.instant("marker")
    assert len(obs.default_tracer()) == 0
    _seeded_loop()
    assert list(tmp_path.iterdir()) == []


def test_tracer_exports_chrome_events(tmp_path):
    path = tmp_path / "trace.json"
    trace.configure(str(path))
    try:
        with obs.span("outer", k=1):
            obs.instant("mark")
        assert trace.flush_export() == str(path)
    finally:
        trace.configure(None)
    events = json.loads(path.read_text())["traceEvents"]
    assert sorted(e["ph"] for e in events) == ["X", "i"]
    assert {e["name"] for e in events} == {"outer", "mark"}
    assert len(obs.default_tracer()) == 0 and not obs.default_tracer().enabled


def _seeded_loop(B=4, cap=8, rounds=6, rpd=2, depth=2):
    rs = np.random.default_rng(3)
    faulty = rs.random((B, cap)) < 0.25
    state = SimState(order=torch.from_numpy(rs.integers(0, 2, B).astype(np.int8)),
                     leader=torch.zeros(B, dtype=torch.int32), faulty=torch.from_numpy(faulty),
                     alive=torch.ones((B, cap), dtype=torch.bool),
                     ids=torch.arange(1, cap + 1, dtype=torch.int32).repeat(B, 1))
    return coalesced_sweep([rng.key(s, device="cpu") for s in range(B)], state, rounds,
                           rounds_per_dispatch=rpd, depth=depth, device="cpu")


def test_health_sampler_gauges_from_the_coalesced_loop(monkeypatch):
    reg = registry.MetricsRegistry()
    monkeypatch.setattr(registry, "_default", reg)
    _seeded_loop()  # the instruments exist before the sampler's baseline
    sampler = health.HealthSampler(timeout_s=30.0)
    sampler.prime()
    out = _seeded_loop()
    snap = sampler.sample()
    assert out["stats"]["dispatches"] == 3
    assert reg.get("pipeline_dispatches_total").value == 6
    assert reg.get("pipeline_retires_total").value == 6
    assert snap["rounds_total"] == 12 and snap["retires_total"] == 6
    # occupancy recorded after each dispatch: 1, 2, then 3 (buckets <= 1, (1, 2], (2, 4])
    assert reg.get("pipeline_depth_occupancy").peek()["counts"][:4] == [2, 2, 2, 0]
    assert snap["depth_occupancy"] == 2.0
    assert snap["retire_lag_p50_s"] is not None and snap["retire_lag_p99_s"] is not None
    assert snap["watchdog_margin_s"] is not None and snap["watchdog_margin_s"] < 30.0
    assert snap["rounds_per_s"] > 0
    for name, key in (("health_depth_occupancy", "depth_occupancy"),
                      ("health_retire_lag_p99_s", "retire_lag_p99_s"),
                      ("health_rounds_per_s", "rounds_per_s")):
        assert reg.get(name).value == snap[key]
    assert set(health.HEALTH_GAUGES) <= set(j_health.HEALTH_GAUGES)
    assert set(snap) == set(j_health.HealthSampler(j_registry.MetricsRegistry()).sample())
    again = sampler.sample()  # an empty window reads None, not lifetime numbers
    assert again["depth_occupancy"] is None and again["retire_lag_p99_s"] is None
