"""The port's SLO engine (``ba_tpu_torch/obs/slo.py``) against the JAX
package's (``ba_tpu/obs/slo.py``), and the engine on the port's service.

- Policy documents round-trip through both packages to the same doc, and
  a file written by one loads in the other.
- ``recommend_replicas`` agrees on a seeded grid.
- Both engines, fed the same seeded stream of ``request`` and rejected
  ``admission`` records under the same fake clock, emit equal
  ``slo_report``, ``slo_alert`` and ``autoscale_signal`` records and set
  equal gauges, all but ``run_id``.  Tolerance: exact (the records are
  compared as JSON values).
- ``python -m ba_tpu_torch.obs.slo`` runs without torch and renders the
  reference's offline report.
- A CPU service (``device="cpu"``, ``engine="torch"``) with ``slo`` set:
  the attribution sum under a retire stall, per-tenant accounting in one
  coalesced batch, no wait with the engine installed, and the REPL's
  ``stats --live`` SLO line (the counterparts of ``tests/test_slo.py``).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ba_tpu.obs import registry as j_registry
from ba_tpu.obs import slo as j_slo
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import make_state
from ba_tpu_torch.crypto import pool as t_pool
from ba_tpu_torch.obs import slo
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.runtime import chaos
from ba_tpu_torch.runtime.backends import PyBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.runtime.serve import AgreementRequest, AgreementService, ServeConfig
from ba_tpu_torch.utils import metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVING_POLICY = ROOT / "examples" / "slo" / "serving.json"


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def _policy_doc(pkg, **dials):
    return pkg.SLOPolicy(objectives=(
        pkg.SLOObjective(name="wall", latency_s=0.05, target=0.5, window_s=120.0,
                         fast_window_s=10.0, slow_window_s=40.0, burn_threshold=1.5),
        pkg.SLOObjective(name="alpha-order", latency_s=0.02, target=0.9, window_s=60.0,
                         fast_window_s=5.0, slow_window_s=20.0, burn_threshold=2.0,
                         tenant="alpha", kind="actual-order"),
    ), **dials)


def test_policy_documents_round_trip_through_both_packages(tmp_path):
    docs = [slo.default_policy().to_doc(), _policy_doc(slo, report_every_s=0.25,
                                                       max_replicas=4).to_doc(),
            slo.SLOPolicy.load(str(SERVING_POLICY)).to_doc()]
    assert docs[0] == j_slo.default_policy().to_doc()
    assert docs[1] == _policy_doc(j_slo, report_every_s=0.25, max_replicas=4).to_doc()
    for i, doc in enumerate(docs):
        assert doc["format"] == j_slo.POLICY_FORMAT == slo.POLICY_FORMAT and doc["v"] == 1
        assert j_slo.SLOPolicy.from_doc(doc).to_doc() == doc
        assert slo.SLOPolicy.from_doc(j_slo.SLOPolicy.from_doc(doc).to_doc()).to_doc() == doc
        path = tmp_path / f"p{i}.json"
        slo.SLOPolicy.from_doc(doc).save(str(path))
        assert j_slo.SLOPolicy.load(str(path)).to_doc() == doc
        j_slo.SLOPolicy.from_doc(doc).save(str(path))
        assert slo.SLOPolicy.load(str(path)).to_doc() == doc
    for bad in ({**docs[0], "surprise": 1}, {**docs[0], "v": 2}, {**docs[0], "objectives": []}):
        with pytest.raises(slo.SLOPolicyError):
            slo.SLOPolicy.from_doc(bad)
        with pytest.raises(j_slo.SLOPolicyError):
            j_slo.SLOPolicy.from_doc(bad)


def test_recommend_replicas_agrees_on_a_seeded_grid():
    rs = np.random.default_rng(21)
    queue = [None, 0.0, 0.25, 0.5, 0.875, 1.0, *rs.uniform(0, 1, 12).round(4).tolist()]
    burn = [None, 0.0, 0.5, 1.0, 2.0, 9.0, *rs.uniform(0, 4, 12).round(4).tolist()]
    for qf in queue:
        for b in burn:
            for replicas in (1, 2, 3, 6):
                for cap in (1, 4, 8):
                    assert slo.recommend_replicas(qf, b, replicas, cap) == \
                        j_slo.recommend_replicas(qf, b, replicas, cap), (qf, b, replicas, cap)


def _stream(seed, n=400):
    """A seeded stream of (time, record, report?) steps: ok requests of
    three tenants and two cohorts (some slow, some with a phase missing),
    failed and expired ones, and rejects, with a report about every
    second of fake time."""
    rs = np.random.default_rng(seed)
    t, steps = 0.0, []
    for i in range(n):
        t += float(rs.exponential(0.12))
        tenant = ["alpha", "beta", None][int(rs.integers(3))]
        cohort = ["plain.r2.c4.torch.m1", "scenario.r4.c8.cuda.m1"][int(rs.integers(2))]
        kind = ["run-rounds", "actual-order", "scenario"][int(rs.integers(3))]
        u = rs.random()
        if u < 0.08:
            rec = {"event": "admission", "v": 1, "decision": "reject",
                   "reason": ["queue_full", "shed_interactive"][int(rs.integers(2))],
                   "kind": kind, "tenant": tenant, "cohort": cohort, "tier": 0,
                   "queue_depth": 16}
        else:
            # a burst of slow requests in the middle third
            slow = n // 3 < i < 2 * n // 3 and rs.random() < 0.7
            wall = round(float(rs.uniform(0.06, 0.4) if slow else rs.uniform(0.001, 0.04)), 6)
            cut = rs.dirichlet(np.ones(5)) * wall
            phases = dict(zip(slo.PHASES, (round(float(v), 6) for v in cut)))
            status = "ok" if u < 0.9 else ["failed", "expired"][int(rs.integers(2))]
            if status != "ok" or rs.random() < 0.05:
                phases["dispatch_s"] = None
            rec = {"event": "request", "v": 1, "status": status, "kind": kind,
                   "tenant": tenant, "cohort": cohort, "wall_s": wall, **phases}
        steps.append((t, rec, rs.random() < 0.12))
    return steps


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_engines_emit_equal_records_on_a_seeded_stream(seed):
    clock = [0.0]
    t_reg, j_reg = MetricsRegistry(), j_registry.MetricsRegistry()
    engines = (slo.SLOEngine(_policy_doc(slo, report_every_s=1.0), registry=t_reg,
                             clock=lambda: clock[0]),
               j_slo.SLOEngine(_policy_doc(j_slo, report_every_s=1.0), registry=j_reg,
                               clock=lambda: clock[0]))
    sinks = (_ListSink(), _ListSink())
    for i, (t, rec, report) in enumerate(_stream(seed)):
        clock[0] = t
        for eng in engines:
            eng.fold(dict(rec))
        for eng, sink in zip(engines, sinks):
            eng.queue_frac = (i % 17) / 16
            eng.replicas = 1 + i % 3
            eng.maybe_report(sink=sink, force=report and i % 5 == 0)
    for eng, sink in zip(engines, sinks):
        eng.maybe_report(sink=sink, force=True)

    def strip(records):
        return [{k: v for k, v in r.items() if k != "run_id"} for r in records]

    got, want = strip(sinks[0].records), strip(sinks[1].records)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    kinds = {r["event"] for r in got}
    assert kinds == {"slo_report", "slo_alert", "autoscale_signal"}, kinds
    assert [r["state"] for r in got if r["event"] == "slo_alert"][0] == "fire"
    assert engines[0].reports == engines[1].reports > 10
    assert engines[0].last_worst == engines[1].last_worst
    for name in ("health_slo_burn", "health_slo_worst_p99_s"):
        assert t_reg.get(name).value == j_reg.get(name).value, name
    assert all(slo._flight.valid_run_id(r["run_id"]) for r in sinks[0].records)


def test_slo_cli_runs_without_torch_and_renders_the_reference_report(tmp_path, capsys):
    code = ("import runpy, sys\n"
            f"sys.argv = ['slo', 'validate', {str(SERVING_POLICY)!r}]\n"
            "try:\n"
            "    runpy.run_module('ba_tpu_torch.obs.slo', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ba_tpu', 'torch', 'numpy'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ": OK — 2 objective(s)" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "ba_tpu_torch.obs.slo"], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 2 and "usage: python -m ba_tpu_torch.obs.slo" in proc.stderr
    # the offline report of one records file, by both CLIs
    records = tmp_path / "records.jsonl"
    records.write_text("".join(json.dumps({**rec, "ts": 1000.0 + t}) + "\n"
                               for t, rec, _ in _stream(3, 120)) + "not json\n")
    out = {}
    for name, mod in (("port", slo), ("ref", j_slo)):
        assert mod.main(["report", str(records), str(SERVING_POLICY)]) == 0
        out[name] = json.loads(capsys.readouterr().out)
        out[name].pop("run_id")
    assert out["port"] == out["ref"] and out["port"]["groups"]
    assert slo.main(["default"]) == 0 and json.loads(capsys.readouterr().out) == \
        j_slo.default_policy().to_doc()
    assert slo.main(["bogus"]) == 2


# -- the engine on the port's service ------------------------------------------


@pytest.fixture
def no_pool(monkeypatch):
    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    t_pool.shutdown_defaults()


def _requests(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_attribution_sum_under_retire_stall(tmp_path, no_pool):
    """Every ok request's phases sum to its wall within ATTRIB_TOL_S, and
    a 0.3 s stall of the retire fetch lands in ``retire_lag_s``."""
    plan = chaos.from_dict({"name": "slow-retire", "faults": [
        {"round": 0, "kind": "stall", "phase": "retire", "seconds": 0.3}]})
    sink_path = tmp_path / "slo_stall.jsonl"
    metrics.configure(str(sink_path))
    try:
        svc = AgreementService(
            ServeConfig(max_batch=2, max_queue=8, coalesce_window_s=0.001,
                        rounds_per_dispatch=2, slo=True, device="cpu", engine="torch"),
            fault_plan=plan, registry=MetricsRegistry())
        svc.start()
        out = svc.submit(AgreementRequest(kind="run-rounds", n=4, seed=90, rounds=2,
                                          tenant="stall")).result(timeout=120)
        assert out["counts"]
        stats = svc.stats()
        svc.stop()
    finally:
        metrics.configure(None)
    assert stats["slo"] and stats["slo_reports"] >= 1
    assert slo.installed() is None  # stop() uninstalled it
    recs = [r for r in _requests(sink_path) if r["event"] == "request" and r["status"] == "ok"]
    assert recs
    for rec in recs:
        phases = [rec[k] for k in slo.PHASES]
        assert all(isinstance(p, (int, float)) for p in phases)
        assert abs(sum(phases) - rec["wall_s"]) <= slo.ATTRIB_TOL_S
        assert rec["tenant"] == "stall"
    assert max(r["retire_lag_s"] for r in recs) >= 0.25
    reports = [r for r in _requests(sink_path) if r["event"] == "slo_report"]
    assert reports and reports[-1]["groups"][0]["attribution_bad"] == 0


def test_per_tenant_accounting_single_coalesced_batch(tmp_path, no_pool):
    """Two tenants in one coalesced batch land in two groups, one ok each,
    from the service's last forced report."""
    sink_path, policy = tmp_path / "slo_tenants.jsonl", tmp_path / "policy.json"
    slo.SLOPolicy(objectives=(slo.SLOObjective(name="wall", latency_s=30.0),),
                  report_every_s=0.001).save(str(policy))
    metrics.configure(str(sink_path))
    try:
        svc = AgreementService(
            ServeConfig(max_batch=2, max_queue=8, coalesce_window_s=0.2,
                        rounds_per_dispatch=2, device="cpu", engine="torch",
                        slo=str(policy)),  # a policy file's path
            registry=MetricsRegistry())
        svc.open()
        ta = svc.submit(AgreementRequest(kind="run-rounds", n=4, seed=91, rounds=2,
                                         tenant="alpha"))
        tb = svc.submit(AgreementRequest(kind="run-rounds", n=4, seed=92, rounds=2,
                                         tenant="beta"))
        svc.start()
        ta.result(timeout=120)
        tb.result(timeout=120)
        svc.stop()
    finally:
        metrics.configure(None)
    recs = _requests(sink_path)
    ok = [r for r in recs if r["event"] == "request" and r["status"] == "ok"]
    assert len(ok) == 2 and ok[0]["run_id"] == ok[1]["run_id"]
    assert ok[0]["batch"] == ok[1]["batch"] == 2 and {r["slot"] for r in ok} == {0, 1}
    reports = [r for r in recs if r["event"] == "slo_report"]
    last = {g["tenant"]: g["counts"]["ok"] for g in reports[-1]["groups"]}
    assert last == {"alpha": 1, "beta": 1}
    for g in reports[-1]["groups"]:
        assert g["attribution_checked"] == 1 and g["attribution_bad"] == 0
        assert g["cohort"] == "plain.r2.c4.torch.m1"


def test_no_blocking_with_slo_engine_installed(monkeypatch):
    """With an installed engine reporting on every health sample, the
    sweep's dispatch / retire order is the depth-k one and nothing
    synchronizes the device."""
    def forbidden(*a, **k):
        raise AssertionError("torch.cuda.synchronize called with the SLO engine installed")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    eng = slo.SLOEngine(slo.SLOPolicy(objectives=(slo.SLOObjective(name="w", latency_s=1.0),),
                                      report_every_s=1e-9), registry=MetricsRegistry())
    eng.fold({"event": "request", "status": "ok", "wall_s": 0.5, "tenant": "t"})
    slo.install(eng)
    try:
        B, cap, R, depth = 8, 8, 7, 3
        events = []
        out = tp.pipeline_sweep(rng.key(23, device="cpu"), make_state(B, cap, device="cpu"),
                                R, depth=depth, rounds_per_dispatch=1, health_every=1,
                                on_event=lambda kind, i: events.append((kind, i)),
                                device="cpu")
    finally:
        slo.install(None)
    assert [i for kind, i in events if kind == "dispatch"] == list(range(R))
    assert [i for kind, i in events if kind == "retire"] == list(range(R))
    first_retire = events.index(("retire", 0))
    assert events[:first_retire] == [("dispatch", i) for i in range(depth + 1)]
    assert out["stats"]["max_in_flight"] == depth + 1
    assert out["stats"]["health_samples"] == R and eng.reports == R


def test_repl_stats_live_slo_line():
    cluster = Cluster(4, PyBackend(), seed=0)
    lines = []
    handle_command(cluster, "stats --live", lines.append)
    assert not any("slo_worst" in ln for ln in lines)
    eng = slo.SLOEngine(slo.default_policy(), registry=MetricsRegistry())
    eng.fold({"event": "request", "v": 1, "id": 1, "status": "ok", "kind": "run-rounds",
              "cohort": "plain.r2.c4.torch.m1", "tenant": "alpha", "wall_s": 2.0,
              "queue_s": 1.9, "coalesce_s": 0.025, "compile_s": 0.0, "dispatch_s": 0.05,
              "retire_lag_s": 0.025})
    slo.install(eng)
    try:
        lines.clear()
        handle_command(cluster, "stats --live", lines.append)
    finally:
        slo.install(None)
    (line,) = [ln for ln in lines if ln.startswith("slo_worst")]
    assert line == ("slo_worst burn=100.0 cohort=plain.r2.c4.torch.m1 tenant=alpha "
                    "p99_s=2.097152 phase=queue_s")
