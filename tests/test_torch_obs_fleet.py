"""The port's fleet-scope trace merge (``ba_tpu_torch/obs/fleet.py``) and the
sign pool's cross-process spans, against the JAX package's on the CPU.

The merge, the coalesced fan-in graft and the rollup run on hand-written
shards and on the committed fixtures (``tests/fixtures/fleet``); the
JAX package's merge of the same shards gives the same records, digest
and summary.  A pool worker writes its ``pool_task`` span into its own
shard of the parent's sink directory, parented under the traceparent
the task carried, and writes nothing when the sink is a file.  A signed
request served with the pool live assembles into one tree across the
dispatcher's and the workers' shards.  ``stats --fleet`` prints the
reference's line; without a directory sink it prints the one line that
differs (the port names ``utils.metrics.configure`` where the reference
names ``BA_TPU_METRICS``)."""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from ba_tpu.obs import fleet as j_fleet
from ba_tpu.runtime.backends import PyBackend as JPyBackend
from ba_tpu.runtime.cluster import Cluster as JCluster
from ba_tpu.runtime.repl import handle_command as j_handle
from ba_tpu.utils import metrics as j_metrics
from ba_tpu_torch.crypto import pool as sign_pool
from ba_tpu_torch.obs import fleet
from ba_tpu_torch.runtime.backends import PyBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import FLEET_NO_SINK, handle_command
from ba_tpu_torch.utils import metrics

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "fleet"
EXT_TRACE = "0af7651916cd43dd8448eb211c80319c"


def _write_shard(dirpath, name, lines):
    with open(os.path.join(dirpath, name), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _request(rid, trace, span, parent=None):
    rec = {"event": "request", "v": 1, "id": rid, "kind": "run-rounds", "status": "ok",
           "cohort": "c", "tenant": None, "wall_s": 0.5, "queue_s": 0.1, "coalesce_s": 0.1,
           "compile_s": 0.0, "dispatch_s": 0.2, "retire_lag_s": 0.1, "trace_id": trace,
           "span_id": span}
    if parent is not None:
        rec["parent_id"] = parent
    return json.dumps(rec)


def _same_as_reference(d):
    """The port's merge of ``d`` equals the JAX package's, record for
    record, digest and summary included."""
    merged = fleet.merge_shards(d)
    assert merged == j_fleet.merge_shards(d)
    assert fleet.merge_digest(merged) == j_fleet.merge_digest(merged)
    assert fleet.fleet_summary(merged) == j_fleet.fleet_summary(merged)
    for rid in fleet.request_ids(merged):
        assert fleet.assemble_request_trace(merged, rid) == \
            j_fleet.assemble_request_trace(merged, rid)
    return merged


def test_merge_aligns_clocks_and_tolerates_torn_tail(tmp_path):
    d = str(tmp_path)
    _write_shard(d, "11.aaaa.jsonl", [
        '{"event": "clock_anchor", "v": 1, "pid": 11, "shard": "11.aaaa.jsonl", '
        '"perf_t": 5.0, "ts": 2000.0}',
        '{"event": "trace_span", "v": 1, "name": "late", "trace_id": "%s", '
        '"span_id": "aaaaaaaaaaaaaaaa", "parent_id": null, "t_perf": 10.0, "dur_s": 0.1}'
        % EXT_TRACE,
    ])
    _write_shard(d, "22.bbbb.jsonl", [
        '{"event": "clock_anchor", "v": 1, "pid": 22, "shard": "22.bbbb.jsonl", '
        '"perf_t": 1001.0, "ts": 2001.0}',
        '{"event": "trace_span", "v": 1, "name": "early", "trace_id": "%s", '
        '"span_id": "bbbbbbbbbbbbbbbb", "parent_id": "aaaaaaaaaaaaaaaa", '
        '"t_perf": 1002.0, "dur_s": 0.1}' % EXT_TRACE,
        '{"event": "trace_span", "v": 1, "name": "torn-ta',
    ])
    merged = _same_as_reference(d)
    assert [r["name"] for r in merged if r["event"] == "trace_span"] == ["early", "late"]
    assert [r["t_align"] for r in merged if r["event"] == "trace_span"] == [2002.0, 2005.0]
    assert merged == fleet.merge_shards(d)
    assert fleet.span_nodes(merged)["bbbbbbbbbbbbbbbb"]["parent_id"] == "aaaaaaaaaaaaaaaa"


def test_assemble_grafts_coalesced_fan_in(tmp_path):
    d = str(tmp_path)
    t1, t2, r1, r2, batch, window = "1" * 32, "2" * 32, "a" * 16, "c" * 16, "b" * 16, "d" * 16
    _write_shard(d, "33.main.jsonl", [
        '{"event": "clock_anchor", "v": 1, "pid": 33, "shard": "33.main.jsonl", '
        '"perf_t": 0.0, "ts": 100.0}',
        '{"event": "trace_span", "v": 1, "name": "serve_batch", "trace_id": "%s", '
        '"span_id": "%s", "parent_id": "%s", "t_perf": 1.0, "dur_s": 0.5, '
        '"fan_in": ["%s", "%s"]}' % (t1, batch, r1, r1, r2),
        '{"event": "trace_span", "v": 1, "name": "flight_span", "trace_id": "%s", '
        '"span_id": "%s", "parent_id": "%s", "t_perf": 1.1, "dur_s": 0.2}'
        % (t1, window, batch),
        _request(1, t1, r1), _request(2, t2, r2),
    ])
    merged = _same_as_reference(d)
    own = fleet.assemble_request_trace(merged, request_id=1)
    assert own["root_span"] == r1 and own["unparented"] == []
    assert {s["name"] for s in own["spans"]} == {"request", "serve_batch", "flight_span"}
    grafted = fleet.assemble_request_trace(merged, request_id=2)
    by_id = {s["span_id"]: s for s in grafted["spans"]}
    assert grafted["trace_id"] == t2 and by_id[batch]["parent_id"] == r2
    assert by_id[window]["parent_id"] == batch and grafted["unparented"] == []
    assert grafted["within_tol"] is True
    assert grafted["attribution_s"] == pytest.approx(0.5)


def test_assemble_shared_trace_excludes_siblings(tmp_path):
    d = str(tmp_path)
    t, ext, r1, r2, batch = "e" * 32, "f" * 16, "1" * 16, "2" * 16, "3" * 16
    _write_shard(d, "44.main.jsonl", [
        '{"event": "clock_anchor", "v": 1, "pid": 44, "shard": "44.main.jsonl", '
        '"perf_t": 0.0, "ts": 100.0}',
        '{"event": "trace_span", "v": 1, "name": "serve_batch", "trace_id": "%s", '
        '"span_id": "%s", "parent_id": "%s", "t_perf": 1.0, "dur_s": 0.5, '
        '"fan_in": ["%s", "%s"]}' % (t, batch, r1, r1, r2),
        _request(1, t, r1, ext), _request(2, t, r2, ext),
    ])
    merged = _same_as_reference(d)
    for rid, root, sibling in ((1, r1, r2), (2, r2, r1)):
        tr = fleet.assemble_request_trace(merged, request_id=rid)
        ids = {s["span_id"] for s in tr["spans"]}
        assert root in ids and batch in ids and sibling not in ids
        assert tr["unparented"] == []
        assert {s["span_id"]: s for s in tr["spans"]}[batch]["parent_id"] == root


def test_committed_fixtures_assemble_fully_parented_as_the_reference():
    merged = _same_as_reference(str(FIXTURES))
    assert len({r["shard"] for r in merged}) == 2
    rids = fleet.request_ids(merged)
    assert len(rids) == 3
    for rid in rids:
        tr = fleet.assemble_request_trace(merged, request_id=rid)
        assert tr["unparented"] == [] and tr["within_tol"] is True
    summary = fleet.fleet_summary(merged)
    assert summary["requests"] == 3 and summary["traces"] == 3 and summary["pool_tasks"] >= 1
    assert fleet.summary_line(summary) == j_fleet.summary_line(summary)
    assert fleet.assemble_fleet(str(FIXTURES)) == j_fleet.assemble_fleet(str(FIXTURES))


def test_the_cli_prints_the_reference_summary(capsys):
    assert fleet._main([str(FIXTURES)]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert j_fleet._main([str(FIXTURES)]) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert ours["all_spans_parented"] and ours["merge_deterministic"]
    assert fleet._main([]) == 2


def _verify_with_pool(traceparent):
    from ba_tpu_torch.crypto.tables import verify_host_exact

    p = sign_pool.SignPool(1)
    try:
        assert p.workers == 1
        pks = np.zeros((2, 32), np.uint8)
        msgs = np.zeros((2, 3, 8), np.uint8)
        sigs = np.zeros((2, 3, 64), np.uint8)
        np.testing.assert_array_equal(p.verify_rows(pks, msgs, sigs, traceparent=traceparent),
                                      verify_host_exact(pks, msgs, sigs))
    finally:
        p.close()


def test_pool_worker_writes_its_own_shard_and_a_parented_span(tmp_path):
    d = str(tmp_path / "sink") + os.sep
    os.makedirs(d)
    metrics.configure(d)
    try:
        _verify_with_pool(metrics.format_traceparent("ab" * 16, "cd" * 8))
    finally:
        metrics.configure(None)
    merged = _same_as_reference(d)
    pids = {int(fleet.SHARD_RE.match(r["shard"]).group(1)) for r in merged}
    assert os.getpid() not in pids and len(pids) == 1
    (task,) = [r for r in merged if r.get("event") == "pool_task"]
    assert task["kind"] == "verify" and task["rows"] == 2
    assert isinstance(task["wall_s"], float) and isinstance(task["t_perf"], float)
    assert task["trace_id"] == "ab" * 16 and task["parent_id"] == "cd" * 8
    assert len(task["span_id"]) == 16
    (shard,) = fleet.list_shards(d)
    assert fleet.read_shard(shard[1])[0]["event"] == "clock_anchor"


def test_pool_workers_follow_the_sink_and_write_nothing_for_a_file(tmp_path):
    """A file sink is not handed to the workers: the parent's file gets no
    ``pool_task``.  A pool made before a directory sink was configured
    hands the directory over at its next task."""
    path = tmp_path / "one.jsonl"
    metrics.configure(str(path))
    try:
        _verify_with_pool(metrics.format_traceparent("ab" * 16, "cd" * 8))
    finally:
        metrics.configure(None)
    assert os.listdir(tmp_path) == []  # no worker opened the file, nor a shard
    p = sign_pool.SignPool(1)
    d = str(tmp_path / "later") + os.sep
    metrics.configure(d)
    try:
        p.verify_rows(np.zeros((1, 32), np.uint8), np.zeros((1, 3, 8), np.uint8),
                      np.zeros((1, 3, 64), np.uint8))
    finally:
        p.close()
        metrics.configure(None)
    (task,) = [r for r in fleet.merge_shards(d) if r.get("event") == "pool_task"]
    assert "trace_id" not in task  # untraced: no parent to name


def test_a_served_signed_request_assembles_across_processes(tmp_path):
    """A signed request served on the CPU with the pool live and the cache
    off: its tree holds the dispatcher's spans and the workers'
    ``pool_task`` spans, every span parented, the phases within
    tolerance."""
    from ba_tpu_torch.obs.registry import MetricsRegistry
    from ba_tpu_torch.runtime.serve import AgreementRequest, AgreementService, ServeConfig

    d = str(tmp_path / "sink") + os.sep
    sign_pool.configure_defaults(workers=2, cache=False)
    metrics.configure(d)
    try:
        svc = AgreementService(ServeConfig(max_batch=2, coalesce_window_s=0.02,
                                           rounds_per_dispatch=4, device="cpu"),
                               registry=MetricsRegistry())
        svc.start()
        tickets = [svc.submit(AgreementRequest(kind="run-rounds", n=4, seed=7000 + i,
                                               rounds=4, signed=True, faulty=((2,), ())[i],
                                               tenant=f"tenant-{i}"), deadline_s=None)
                   for i in range(2)]
        for t in tickets:
            t.result(timeout=120)
        svc.stop()
    finally:
        metrics.configure(None)
        sign_pool.configure_defaults()
    merged = _same_as_reference(d)
    rids = fleet.request_ids(merged)
    assert len(rids) == 2
    for rid in rids:
        tr = fleet.assemble_request_trace(merged, request_id=rid)
        assert tr["unparented"] == [], tr["unparented"]
        assert tr["within_tol"] is True
        assert len(tr["processes"]) >= 2
        assert any(s["name"] == "pool_task" for s in tr["spans"])


def test_stats_fleet_prints_the_reference_line(tmp_path):
    ours, theirs = Cluster(4, PyBackend(), seed=0), JCluster(4, JPyBackend(), seed=0)
    got, want = [], []
    handle_command(ours, "stats --fleet", got.append)
    j_handle(theirs, "stats --fleet", want.append)
    # the one line that differs: the port reads no BA_TPU_METRICS
    assert got == [FLEET_NO_SINK] and want != got
    assert got[0].startswith("fleet (no sharded sink — ") and want[0].startswith(
        "fleet (no sharded sink — ")
    copy = tmp_path / "fixtures"
    shutil.copytree(FIXTURES, copy)
    got, want = [], []
    metrics.configure(str(copy))
    j_metrics.configure(str(copy))
    try:
        handle_command(ours, "stats --fleet", got.append)
        j_handle(theirs, "stats --fleet", want.append)
    finally:
        metrics.configure(None)
        j_metrics.configure(None)
    assert sorted(os.listdir(copy)) == sorted(os.listdir(FIXTURES))
    assert got == want and got[0].startswith("fleet replicas=2")
    assert "requests=3" in got[0] and "traces=3" in got[0]
