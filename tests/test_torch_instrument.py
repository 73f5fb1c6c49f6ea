"""The port's compile classification, recompile explainer and cross-run
compile ledger (``ba_tpu_torch/obs/instrument.py``) against the JAX
package's (``ba_tpu/obs/instrument.py``), and the device tier's pieces
that run without a card (``obs/cuda.py``, the ``ptxas`` report parser of
``ops/_build.py``).

- ``classify_compile`` gives equal results in both packages over a seeded
  sequence of ``(fn, axes)``, with and without a ledger, and the two
  ledger files hold equal rows.
- The ledger's cases of ``tests/test_obs_xla.py``: the first compile of a
  session explained, silence on an identical signature, a corrupt file
  starting fresh, every specialisation remembered, the closest prior
  signature, concurrent writers merged.
- ``pipeline_sweep`` and ``coalesced_sweep`` open one ``compile`` span a
  signature, then ``dispatch`` spans; a warm entry's dispatch is a
  ``warm`` ``dispatch`` span.  ``TorchBackend``'s round at a new capacity
  emits a ``recompile`` record naming ``capacity``.
- ``warmup.ledger_replay_set`` / ``service_plan`` take only ``torch`` and
  ``cuda`` rows of this toolchain, unsharded, ahead of the lattice, and a
  service with ``compile_ledger=`` warms what an earlier one dispatched.
- The artifact record's arithmetic on CPU tensors (the card's memory
  counters stubbed), the dump directory, and the ``ptxas -v`` parser on a
  fixed report.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ba_tpu.obs import instrument as j_instrument
from ba_tpu_torch import obs
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import make_state
from ba_tpu_torch.crypto import pool as t_pool
from ba_tpu_torch.obs import cuda as obs_cuda
from ba_tpu_torch.obs import instrument
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.obs.trace import Tracer
from ba_tpu_torch.ops import _build
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.runtime import warmup
from ba_tpu_torch.runtime.backends import TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.serve import AgreementRequest, AgreementService, ServeConfig
from ba_tpu_torch.utils import metrics


@pytest.fixture
def fresh_obs(monkeypatch, tmp_path):
    """A fresh tracer (on), registry and classifier, and a live sink in
    tmp_path (its path yielded); the ledger off before and after."""
    monkeypatch.setattr(obs.trace, "_default", Tracer(enabled=True))
    monkeypatch.setattr(obs.registry, "_default", MetricsRegistry())
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setattr(metrics, "_default", metrics.MetricsSink(str(path)))
    instrument.reset_first_calls()
    instrument.configure_compile_ledger(None)
    yield path
    metrics.default_sink().close()
    instrument.reset_first_calls()
    instrument.configure_compile_ledger(None)


def _records(path, event=None):
    metrics.default_sink().close()
    if not path.exists():
        return []
    recs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [r for r in recs if event is None or r["event"] == event]


def _spans(names=("compile", "dispatch")):
    return [(e["name"], e["args"]) for e in obs.default_tracer().chrome_events()
            if e["name"] in names]


def _signatures(seed, n=60):
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fn = ["pipeline_megastep", "coalesced_megastep", "torch_backend_step"][int(rs.integers(3))]
        axes = {"capacity": int(2 ** rs.integers(2, 5)), "rounds": int(rs.integers(1, 4)),
                "engine": ["torch", "cuda"][int(rs.integers(2))]}
        if rs.random() < 0.3:
            axes["m"] = int(rs.integers(1, 3))
        out.append((fn, axes))
    return out


@pytest.mark.parametrize("ledgered", [False, True])
def test_classify_compile_agrees_with_the_reference(tmp_path, ledgered):
    env_old, env_new = {"toolchain": "a"}, {"toolchain": "b"}
    got, want = [], []
    try:
        for session, env in enumerate((env_old, env_new, env_new)):
            for mod in (instrument, j_instrument):
                mod.reset_first_calls()
                mod.configure_compile_ledger(
                    str(tmp_path / f"{mod.__name__}.json") if ledgered else None, env)
            for fn, axes in _signatures(session):
                got.append(instrument.classify_compile(fn, dict(axes)))
                want.append(j_instrument.classify_compile(fn, dict(axes)))
        assert got == want
        assert any(c for _, c, _ in got) and (any(x for *_, x in got) == ledgered)
        if ledgered:
            rows = [json.loads((tmp_path / f"{m.__name__}.json").read_text())
                    for m in (instrument, j_instrument)]
            assert rows[0] == rows[1]
            assert instrument.ledger_signatures() == j_instrument.ledger_signatures()
            assert instrument.ledger_env_axes() == env_new
    finally:
        for mod in (instrument, j_instrument):
            mod.reset_first_calls()
            mod.configure_compile_ledger(None)


def test_ledger_explains_first_compile_of_the_session(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    obs.configure_compile_ledger(str(ledger), {"torch": "2.10"})
    with obs.compile_or_dispatch_span("fnl", axes={"capacity": 4}) as p:
        assert p == "compile"
    assert _records(fresh_obs, "recompile") == []  # nothing to diff against
    assert json.loads(ledger.read_text())["fns"]["fnl"] == [{"capacity": 4, "torch": "2.10"}]
    obs.reset_first_calls()  # "a new process"
    obs.configure_compile_ledger(str(ledger), {"torch": "2.11"})
    with obs.compile_or_dispatch_span("fnl", axes={"capacity": 4}) as p:
        assert p == "compile"
    (rec,) = _records(fresh_obs, "recompile")
    assert rec["fn"] == "fnl" and rec["cross_process"] is True
    assert rec["changed"] == {"torch": ["2.10", "2.11"]}
    assert obs.default_registry().snapshot()["recompiles_total"]["value"] == 1


def test_ledger_silent_on_identical_signature_and_unknown_fn(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    with obs.compile_or_dispatch_span("fns", axes={"m": 1}):
        pass
    obs.reset_first_calls()
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    with obs.compile_or_dispatch_span("fns", axes={"m": 1}) as p:
        assert p == "compile"
    with obs.compile_or_dispatch_span("fresh_fn", axes={"m": 2}) as p:
        assert p == "compile"
    assert _records(fresh_obs, "recompile") == []
    with obs.compile_or_dispatch_span("fns", axes={"m": 3}):
        pass
    (rec,) = _records(fresh_obs, "recompile")
    assert rec["cross_process"] is False and rec["changed"] == {"m": [1, 3]}
    doc = json.loads(ledger.read_text())
    assert [s["m"] for s in doc["fns"]["fns"]] == [1, 3]
    assert [s["m"] for s in doc["fns"]["fresh_fn"]] == [2]


def test_ledger_corrupt_file_starts_fresh(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    ledger.write_text("{not json")
    obs.configure_compile_ledger(str(ledger), {})
    with obs.compile_or_dispatch_span("fnc", axes={"n": 1}) as p:
        assert p == "compile"
    assert _records(fresh_obs, "recompile") == []
    assert json.loads(ledger.read_text())["fns"]["fnc"] == [{"n": 1}]


def test_ledger_remembers_every_specialization(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    for cap in (4, 8):
        with obs.compile_or_dispatch_span("fnm", axes={"capacity": cap}):
            pass
    (rec,) = _records(fresh_obs, "recompile")
    assert rec["cross_process"] is False
    obs.reset_first_calls()
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    with obs.compile_or_dispatch_span("fnm", axes={"capacity": 4}) as p:
        assert p == "compile"
    assert not [r for r in _records(fresh_obs, "recompile") if r["cross_process"]]
    obs.reset_first_calls()
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    with obs.compile_or_dispatch_span("fnm", axes={"capacity": 16}):
        pass
    cross = [r for r in _records(fresh_obs, "recompile") if r["cross_process"]]
    assert [r["changed"] for r in cross] == [{"capacity": [8, 16]}]


def test_ledger_diffs_against_closest_prior_signature(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    obs.configure_compile_ledger(str(ledger), {"torch": "old"})
    for cap in (4, 8):
        with obs.compile_or_dispatch_span("fnc", axes={"capacity": cap}):
            pass
    obs.reset_first_calls()
    obs.configure_compile_ledger(str(ledger), {"torch": "new"})
    with obs.compile_or_dispatch_span("fnc", axes={"capacity": 4}):
        pass
    cross = [r for r in _records(fresh_obs, "recompile") if r["cross_process"]]
    assert [r["changed"] for r in cross] == [{"torch": ["old", "new"]}]


def test_ledger_merges_concurrent_writer_rows(fresh_obs, tmp_path):
    ledger = tmp_path / "axes_ledger.json"
    obs.configure_compile_ledger(str(ledger), {"torch": "A"})
    other = {"capacity": 16, "torch": "A"}
    ledger.write_text(json.dumps({"v": 1, "fns": {"other_fn": [other]}}))
    with obs.compile_or_dispatch_span("mine", axes={"capacity": 4}):
        pass
    doc = json.loads(ledger.read_text())
    assert doc["fns"]["other_fn"] == [other]
    assert {"capacity": 4, "torch": "A"} in doc["fns"]["mine"]


def test_toolchain_axes_are_the_ledgers_default(fresh_obs, tmp_path):
    axes = instrument.toolchain_axes()
    assert axes["package"] == "ba_tpu_torch" and axes["torch"] == torch.__version__
    assert axes["cuda"] == torch.version.cuda and ("nvcc" in axes) == (
        _build.nvcc_release() is not None)
    obs.configure_compile_ledger(str(tmp_path / "l.json"))
    assert instrument.ledger_env_axes() == axes and instrument.ledger_path().endswith("l.json")
    assert instrument.default_ledger_path().endswith(instrument.LEDGER_NAME)


def test_pipeline_sweep_spans_one_compile_then_dispatches(fresh_obs):
    for rounds in (8, 8, 6):  # windows 4, 4 | 4, 4 | 4, 2
        tp.pipeline_sweep(rng.key(0, device="cpu"), make_state(4, 8, device="cpu"), rounds,
                          rounds_per_dispatch=4, device="cpu")
    spans = _spans()
    assert [(n, a["rounds"]) for n, a in spans] == [
        ("compile", 4), ("dispatch", 4), ("dispatch", 4), ("dispatch", 4), ("dispatch", 4),
        ("compile", 2)]
    assert all(a["library_load"] is False for n, a in spans if n == "compile")
    (rec,) = _records(fresh_obs, "recompile")
    assert rec["fn"] == "pipeline_megastep" and rec["changed"] == {"rounds": [4, 2]}
    assert rec["axes"]["engine"] == "torch" and rec["axes"]["capacity"] == 8
    # the torch engine emits no artifact record, sink or not
    assert _records(fresh_obs, "compiled_artifact") == []
    assert obs.default_registry().snapshot()["compile_time_s"]["count"] == 2


def test_coalesced_sweep_warm_entries_skip_the_classifier(fresh_obs, monkeypatch):
    from ba_tpu_torch.obs.graphcache import GraphCache

    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    keys = [rng.key(s, device="cpu") for s in range(2)]
    cache = GraphCache("cpu")
    axes = {"batch": 2, "capacity": 4, "m": 1, "max_liars": None, "unroll": 1,
            "scenario": False, "signed": False, "collapsed": False, "engine": "torch",
            "rounds": 2}
    cache.ensure("coalesced_megastep", axes)
    out = tp.coalesced_sweep(keys, make_state(2, 4, device="cpu"), 4, rounds_per_dispatch=2,
                             device="cpu", executables=cache)
    assert out["stats"]["warm_dispatches"] == 2
    assert [(n, a.get("warm")) for n, a in _spans()] == [("dispatch", True)] * 2
    tp.coalesced_sweep(keys, make_state(2, 4, device="cpu"), 4, rounds_per_dispatch=2,
                       device="cpu")
    assert [n for n, _ in _spans()][2:] == ["compile", "dispatch"]


def test_torch_backend_capacity_recompile_names_capacity(fresh_obs):
    cluster = Cluster(4, TorchBackend(device="cpu"), seed=0)
    cluster.actual_order("attack")
    cluster.actual_order("attack")
    cluster.add(1)  # n = 5: capacity 4 -> 8
    cluster.actual_order("attack")
    recs = [r for r in _records(fresh_obs, "recompile") if r["fn"] == "torch_backend_step"]
    assert len(recs) == 1 and recs[0]["changed"] == {"capacity": [4, 8]}
    assert [n for n, a in _spans() if a.get("protocol") == "om"] == [
        "compile", "dispatch", "compile"]
    rounds = _records(fresh_obs, "agreement_round")
    assert [r["round"] for r in rounds] == [0, 1, 2] and rounds[-1]["n"] == 5
    signed = TorchBackend(device="cpu", protocol="sm", signed=True)
    Cluster(4, signed, seed=0).actual_order("attack")
    assert "signed_round" in [e["name"] for e in obs.default_tracer().chrome_events()]


def test_ledger_replay_takes_only_this_toolchains_torch_and_cuda_rows(fresh_obs, tmp_path):
    ledger = tmp_path / "l.json"
    env = {"package": "ba_tpu_torch", "torch": "T"}
    base = {"batch": 1, "capacity": 16, "m": 1, "max_liars": None, "unroll": 1,
            "scenario": False, "signed": False, "collapsed": False, "rounds": 8}
    rows = {"coalesced_megastep": [
        {**base, "engine": "torch", **env, "run_id": "run-1"},
        {**base, "engine": "cuda", **env},
        {**base, "engine": "xla", **env},
        {**base, "engine": "pallas", **env},
        {**base, "engine": "torch", "package": "ba_tpu_torch", "torch": "other"},
        {**base, "engine": "torch", "data": 2, **env},
        {**base, "capacity": 32, **env},  # no engine axis: not the port's
    ], "pipeline_megastep": [{**base, "engine": "torch", "data": 1, **env}]}
    ledger.write_text(json.dumps({"v": 1, "fns": rows}))
    obs.configure_compile_ledger(str(ledger), env)
    got = warmup.ledger_replay_set()
    assert got == [("coalesced_megastep", {**base, "engine": "torch"}),
                   ("coalesced_megastep", {**base, "engine": "cuda"}),
                   ("pipeline_megastep", {**base, "engine": "torch", "data": 1})]
    cfg = ServeConfig(max_batch=2, warm_capacities=(4,), device="cpu", engine="torch")
    plan = warmup.service_plan(cfg, "cpu")
    # the ledger's serving rows of the engines a CPU service dispatches, first
    assert plan[0] == ("coalesced_megastep", {**base, "engine": "torch"})
    assert all(axes["engine"] == "torch" for _, axes in plan)
    assert plan[1:] == [p for p in warmup.bucket_lattice(
        2, cfg.rounds_per_dispatch, capacities=(4,), scenarios=(False, True),
        signeds=(False, True), ms=(1,)) if p != plan[0]]


def test_a_service_warms_what_an_earlier_one_dispatched(fresh_obs, tmp_path, monkeypatch):
    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    t_pool.shutdown_defaults()
    ledger = str(tmp_path / "serve_ledger.json")
    req = AgreementRequest(kind="run-rounds", n=12, seed=5, rounds=8)  # capacity 16
    cfg = dict(max_batch=1, rounds_per_dispatch=8, device="cpu", engine="torch",
               compile_ledger=ledger)
    first = AgreementService(ServeConfig(**cfg), registry=MetricsRegistry())
    first.start()
    want = first.submit(req).result(60)
    first.stop()
    assert obs.instrument.ledger_path() is None  # the service's life only
    rows = json.loads(open(ledger).read())["fns"]["coalesced_megastep"]
    assert [(r["capacity"], r["rounds"], r["engine"]) for r in rows] == [(16, 8, "torch")]
    obs.reset_first_calls()  # "a new process"
    second = AgreementService(ServeConfig(**cfg, warm=True, warm_capacities=(4,),
                                          warm_scenarios=False, warm_signed=False),
                              registry=MetricsRegistry())
    second.start()
    assert second.warm_barrier(60)
    got = second.submit(req).result(60)
    stats = second.stats()
    second.stop()
    assert got["decisions"] == want["decisions"] and got["counters"] == want["counters"]
    assert stats["warmup_errors"] == 0 and stats["warmup_misses"] == 0
    assert stats["warmup_planned"] == 2 and stats["compiles_on_request_path"] == 0
    assert [(n, a.get("warm")) for n, a in _spans()][-1] == ("dispatch", True)


def _probe_state(monkeypatch, peak):
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: peak.pop(0))


def test_artifact_record_arithmetic_on_cpu_tensors(fresh_obs, tmp_path, monkeypatch):
    """The probe around the torch engine's plain megastep, which updates
    its state and schedule in place as K1 does: alias bytes are the
    carry's bytes, argument bytes add the counter block; the card's
    memory counters are stubbed (1 000 before, 5 096 after)."""
    _probe_state(monkeypatch, [1000, 5096])
    monkeypatch.setattr(_build, "library_record", lambda src: {
        "path": str(tmp_path / "lib.so"), "bytes": 4321, "kernels": {"_Z1k": {"registers": 64}}})
    obs_cuda.configure(dump_dir=str(tmp_path / "dumps"))
    try:
        state = make_state(16, 32, device="cpu")
        sched = tp.make_key_schedule(rng.key(3, device="cpu"))
        counters = tp.agreement_counters_init("cpu")
        axes = {"batch": 16, "capacity": 32, "rounds": 4}
        probe = obs_cuda.introspect("pipeline_megastep", axes, (state, sched, counters),
                                    sources=tp.K1_SOURCES, device="cpu")
        out = tp.pipeline_megastep(state, sched, rounds=4, counters=counters)
        rec = probe.emit(out)
    finally:
        obs_cuda.configure(dump_dir=None)
    carry = sum(t.nbytes for t in (*out[0].tensors(), out[1].key_data, out[1].counter))
    assert rec["alias_bytes"] == carry and rec["donation_aliased"] is True
    assert rec["argument_bytes"] == carry + counters.nbytes
    assert rec["output_bytes"] == carry + sum(t.nbytes for t in out[2:])
    assert rec["temp_bytes"] == 4096 and rec["generated_code_bytes"] == 4321
    assert rec["flops"] is None and rec["bytes_accessed"] is None
    assert rec["kernels"] == {"_Z1k": {"registers": 64}} and rec["libraries"] == ["megastep.cu"]
    (emitted,) = _records(fresh_obs, "compiled_artifact")
    assert emitted["alias_bytes"] == carry and emitted["axes"] == axes
    assert json.loads(open(rec["dump"] + ".json").read())["alias_bytes"] == carry
    assert obs.default_registry().get("cuda_pipeline_megastep_alias_bytes").value == carry


def test_introspection_off_and_failures_never_raise(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(metrics, "_default", metrics.MetricsSink(None))
    assert not obs_cuda.enabled()
    assert obs_cuda.introspect("f", {}, (), sources=(), device="cpu") is None
    assert obs_cuda.annotate("megastep_dispatch", dispatch=0) is obs_cuda.annotate("x")
    monkeypatch.setattr(metrics, "_default", metrics.MetricsSink(str(tmp_path / "m.jsonl")))
    _probe_state(monkeypatch, [0, 0])
    probe = obs_cuda.introspect("broken_fn", {}, (), sources=("no_such.cu",), device="cpu")
    assert probe.emit(()) is None and probe.emit(()) is None
    assert capsys.readouterr().err.count("introspection of 'broken_fn' failed") == 1


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11ba_megastepILb1EEvPKl' for 'sm_90a'
ptxas info    : Function properties for _Z11ba_megastepILb1EEvPKl
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size, \
1024 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    48 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z8ba_countv' for 'sm_90a'
ptxas info    : Function properties for _Z8ba_countv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 360 bytes cmem[0]
"""


def test_ptxas_report_parser_reads_a_fixed_log(tmp_path, monkeypatch):
    assert _build.ptxas_resources(PTXAS_LOG) == {
        "_Z11ba_megastepILb1EEvPKl": {"registers": 64, "spill_stores": 12, "spill_loads": 8,
                                      "stack_frame": 16, "shared_bytes": 1024,
                                      "local_bytes": 16},
        "_Z8ba_countv": {"registers": 8, "spill_stores": 0, "spill_loads": 0,
                         "stack_frame": 0, "shared_bytes": 0, "local_bytes": 0},
    }
    lib = tmp_path / "megastep_0123.so"
    lib.write_bytes(b"\0" * 100)
    monkeypatch.setattr(_build, "build", lambda source, flags=(): lib)
    assert _build.library_record("megastep.cu") == {"path": str(lib), "bytes": 100,
                                                     "kernels": {}}
    (tmp_path / "megastep_0123.so.ptxas.txt").write_text(PTXAS_LOG)
    rec = _build.library_record("megastep.cu")
    assert rec["kernels"]["_Z8ba_countv"]["registers"] == 8
