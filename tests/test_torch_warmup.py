"""The port's warm serving (``runtime/warmup.py``, ``obs/graphcache.py``)
against the JAX package's (``ba_tpu/runtime/warmup.py``), on the CPU.

- ``bucket_lattice`` and ``service_plan`` equal to the reference's, its
  engine tokens mapped (``xla`` -> ``torch``, ``pallas`` -> ``cuda``);
- the warmup gate pauses the runner until healthy; a failing signature
  is counted and the runner finishes;
- a warm service counts no compile on the request path after the warm
  barrier (on the CPU every entry is eager-warm), dispatches warm, and
  gives the cold service's results bit for bit; an unwarmed window
  counts a miss; warmup never sheds live traffic;
- the graph cache's ``get`` / ``ensure`` / ``evict`` bookkeeping, and a
  warm entry whose replay raises: evicted, the dispatch run eagerly,
  counted, the result unchanged;
- ``aot_cache=`` raises.

A CUDA graph replay held against the eager dispatch needs the card:
``tests/test_torch_kernel.py::test_slot_graph_replay_matches_eager``.
"""

import numpy as np
import pytest
import torch

from ba_tpu.runtime import warmup as j_warmup
from ba_tpu.runtime.serve import ServeConfig as JServeConfig
from ba_tpu_torch import obs
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.crypto import pool as t_pool
from ba_tpu_torch.obs import graphcache
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.parallel.pipeline import coalesced_sweep
from ba_tpu_torch.runtime import warmup
from ba_tpu_torch.runtime.serve import AgreementRequest, AgreementService, ServeConfig

B, CAP, ROUNDS, RPD = 2, 4, 8, 4
AXES = {"batch": B, "capacity": CAP, "rounds": RPD, "m": 1, "max_liars": None, "unroll": 1,
        "scenario": False, "signed": False, "collapsed": False, "engine": "torch"}
ENGINE_MAP = {"xla": "torch", "pallas": "cuda"}


@pytest.fixture(scope="module", autouse=True)
def pool_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pool, "default_workers", lambda: 0)
        t_pool.shutdown_defaults()
        yield
    t_pool.shutdown_defaults()


def mapped(plan):
    return [(fn, {**axes, "engine": ENGINE_MAP.get(axes["engine"], axes["engine"])})
            for fn, axes in plan]


@pytest.mark.parametrize("kw", [
    dict(capacities=(4,), rounds=20),
    dict(capacities=(4, 16), rounds=6, ms=(1, 2), scenarios=(False, True),
         signeds=(False, True)),
    dict(capacities=(8,), m=2),
])
def test_bucket_lattice_equals_reference(kw):
    plan = warmup.bucket_lattice(8, 4, **kw)
    assert plan == mapped(j_warmup.bucket_lattice(8, 4, **kw))
    assert plan == warmup.bucket_lattice(8, 4, **kw)
    if "ms" not in kw and "m" not in kw:  # K1 runs m = 1 only: the kernel's axis is m = 1
        assert warmup.bucket_lattice(8, 4, engines=("torch", "cuda"), **kw) == mapped(
            j_warmup.bucket_lattice(8, 4, engines=("xla", "pallas"), **kw))


def test_bucket_lattice_covers_cohort_space():
    axes = [a for _, a in warmup.bucket_lattice(8, 8, capacities=(4,), rounds=20)]
    assert {a["batch"] for a in axes} == {1, 2, 4, 8}
    assert {a["rounds"] for a in axes} == {4, 8}
    with pytest.raises(ValueError):
        warmup.bucket_lattice(0, 8)
    with pytest.raises(ValueError):
        warmup.builder_for("not_a_megastep")
    cuda = warmup.bucket_lattice(2, 4, engines=("torch", "cuda"), ms=(1, 2))
    assert all(a["m"] == 1 for _, a in cuda if a["engine"] == "cuda")


@pytest.mark.parametrize("kw", [
    dict(max_batch=8, rounds_per_dispatch=8, warm_rounds=20),
    dict(max_batch=4, rounds_per_dispatch=4, warm_rounds=6, warm_capacities=(4, 8),
         warm_ms=(2,), warm_signed=True),
    dict(max_batch=2, rounds_per_dispatch=4, warm_scenarios=False, warm_signed=False),
])
def test_service_plan_equals_reference(kw):
    plan = warmup.service_plan(ServeConfig(device="cpu", engine="torch", **kw))
    assert plan == mapped(j_warmup.service_plan(JServeConfig(engine="xla", **kw)))
    auto = warmup.service_plan(ServeConfig(device="cpu", **kw))
    assert auto == plan  # "auto" on the CPU is the torch engine
    assert warmup.plan_engines(ServeConfig(engine="cuda"), device="cpu") == ("torch",)


def test_warmup_gate_pauses_until_healthy():
    cache = graphcache.GraphCache("cpu")
    healthy = {"v": False}
    runner = warmup.WarmupRunner(cache, [("coalesced_megastep", dict(AXES))],
                                 gate=lambda: healthy["v"], registry=MetricsRegistry(),
                                 pause_s=0.01, device="cpu")
    runner.start()
    assert not runner.wait(0.3)
    assert runner.warmed == 0
    healthy["v"] = True
    assert runner.wait(60.0)
    assert runner.progress()["warmed"] == 1 and runner.progress()["pending"] == 0


def test_health_gate_reads_depth_occupancy(monkeypatch):
    from ba_tpu_torch.obs import registry

    reg = registry.MetricsRegistry()
    monkeypatch.setattr(registry, "_default", reg)
    gate = warmup.health_gate()
    assert gate()  # no window yet: idle
    occ = reg.histogram("pipeline_depth_occupancy", base=1.0, n_buckets=16)
    occ.record(2)
    assert not gate()  # a busy pipeline defers warmup
    assert gate()  # an empty window reads idle again
    occ.record(1)
    assert warmup.health_gate(max_occupancy=2.0, registry=reg)()


def test_warmup_runner_counts_errors_and_finishes():
    cache = graphcache.GraphCache("cpu")
    runner = warmup.WarmupRunner(
        cache, [("pipeline_megastep", {"batch": 1, "capacity": 4, "rounds": 2, "m": 1,
                                       "max_liars": None, "unroll": 1,
                                       "collect_decisions": False, "counters": False,
                                       "data": 8, "scenario": False}),
                ("coalesced_megastep", {**AXES, "engine": "cuda"})],  # no card here
        registry=MetricsRegistry(), device="cpu")
    runner.start()
    assert runner.wait(60.0)
    assert runner.progress()["errors"] == 2 and runner.progress()["warmed"] == 0
    assert runner.done() and not runner.ok()


def test_graph_cache_bookkeeping():
    cache = graphcache.GraphCache("cpu")
    assert cache.get("coalesced_megastep", AXES) is None
    info = cache.ensure("coalesced_megastep", AXES)
    assert info["status"] == "eager" and not info["graph"]
    assert cache.ensure("coalesced_megastep", dict(AXES))["status"] == "cached"
    entry = cache.get("coalesced_megastep", dict(reversed(list(AXES.items()))))
    assert entry is not None and not entry.graph
    # another batch bucket of the same torch signature needs no second dispatch
    assert cache.ensure("coalesced_megastep", {**AXES, "batch": 8})["status"] == "eager"
    assert len(cache) == 2 and cache.graphs() == 0
    cache.evict("coalesced_megastep", AXES)
    assert cache.get("coalesced_megastep", AXES) is None
    assert cache.counts == {"captures": 0, "eager": 2, "hits": 1, "misses": 2, "evicted": 1}
    with pytest.raises(ValueError):
        graphcache.build_entry("pipeline_megastep", AXES, "cpu")
    with pytest.raises(ValueError):
        graphcache.build_entry("coalesced_megastep", {**AXES, "engine": "cuda"}, "cpu")


def test_aot_cache_raises():
    with pytest.raises(ValueError, match="aot_cache"):
        ServeConfig(aot_cache="")
    # ported since: without a configured ledger the replay set is empty
    assert obs.instrument.ledger_path() is None
    assert warmup.ledger_replay_set() == []


def _state(reqs):
    n = len(reqs)
    faulty = np.zeros((n, CAP), bool)
    for i, r in enumerate(reqs):
        faulty[i, list(r.faulty)] = True
    return SimState(order=torch.tensor([1 if r.order == "attack" else 0 for r in reqs],
                                       dtype=torch.int8),
                    leader=torch.zeros(n, dtype=torch.int32), faulty=torch.from_numpy(faulty),
                    alive=torch.ones((n, CAP), dtype=torch.bool),
                    ids=torch.arange(1, CAP + 1, dtype=torch.int32).repeat(n, 1))


def _alone(req, **kw):
    out = coalesced_sweep([rng.key(req.seed, device="cpu")], _state([req]), req.rounds,
                          rounds_per_dispatch=RPD, device="cpu", **kw)
    return out["decisions"][:, 0].tolist(), out


class _FailingGraph:
    graph = True

    def __call__(self, *args, **kw):
        raise RuntimeError("replay failed")


def test_failed_replay_evicts_and_runs_eagerly():
    cache = graphcache.GraphCache("cpu")
    req = AgreementRequest(kind="run-rounds", n=4, faulty=(2,), seed=45, rounds=ROUNDS)
    axes = {**AXES, "batch": 1}
    cache.put("coalesced_megastep", axes, _FailingGraph())
    want, _ = _alone(req)
    got, out = _alone(req, executables=cache)
    assert got == want
    st = out["stats"]
    # the first window fell back (and evicted), the second missed
    assert (st["graph_fallbacks"], st["warm_dispatches"], st["warm_misses"]) == (1, 0, 1)
    assert cache.get("coalesced_megastep", axes) is None and cache.counts["evicted"] == 1


def _warm_service(**kw):
    return AgreementService(ServeConfig(device="cpu", max_batch=2, max_queue=8,
                                        coalesce_window_s=0.002, rounds_per_dispatch=RPD,
                                        warm=True, warm_rounds=ROUNDS, **kw),
                            registry=MetricsRegistry())


def test_service_warm_zero_request_path_compiles():
    from ba_tpu_torch.scenario import spec as t_spec

    svc = _warm_service(warm_ms=(2,))
    svc.open()
    assert svc.warm_barrier(timeout=300)
    svc.start()
    reqs = [AgreementRequest(kind="run-rounds", n=4, seed=41, rounds=ROUNDS),
            AgreementRequest(kind="run-rounds", n=4, faulty=(2,), seed=43, rounds=ROUNDS),
            AgreementRequest(kind="run-rounds", n=4, faulty=(1,), seed=44, rounds=ROUNDS,
                             m=2),
            AgreementRequest(kind="run-rounds", n=4, seed=46, rounds=ROUNDS, signed=True)]
    outs = [svc.submit(r).result(timeout=300) for r in reqs]
    spec = t_spec.from_dict({"name": "warmtest", "rounds": ROUNDS,
                             "events": [{"round": 2, "kill": [3]}]})
    scn = svc.submit(AgreementRequest(kind="scenario", n=4, seed=49, spec=spec)).result(
        timeout=300)
    stats, warm = svc.stats(), svc.warm_stats()
    svc.stop()
    for req, out in zip(reqs, outs):
        want, ref = _alone(req, m=req.m or 1, signed=req.signed, pool=0)
        assert out["decisions"] == want
        assert out["counters"] == dict(zip(ref["counter_names"], ref["counters"][0].tolist()))
    assert len(scn["decisions"]) == ROUNDS and "leaders" in scn
    assert stats["compiles_on_request_path"] == 0 and stats["warmup_misses"] == 0
    assert stats["warmup_done"] and stats["warmup_errors"] == 0
    assert stats["warmup_warmed"] == stats["warmup_planned"]
    assert warm["warm_dispatches"] == 2 * (len(reqs) + 1) and warm["graph_fallbacks"] == 0
    assert warm["graphs_captured"] == 0 and warm["eager_entries"] == stats["warmup_planned"]


def test_service_unwarmed_window_counts_miss():
    svc = _warm_service()
    svc.open()
    assert svc.warm_barrier(timeout=300)
    svc.start()
    req = AgreementRequest(kind="run-rounds", n=4, seed=47, rounds=6)  # windows 4 + 2
    out = svc.submit(req).result(timeout=300)
    stats = svc.stats()
    svc.stop()
    assert out["decisions"] == _alone(req)[0]
    assert stats["warmup_misses"] == 1 and stats["compiles_on_request_path"] == 0


def test_warmup_never_sheds_live_traffic():
    reg = MetricsRegistry()
    svc = AgreementService(ServeConfig(device="cpu", max_batch=2, max_queue=8,
                                       coalesce_window_s=0.002, rounds_per_dispatch=RPD,
                                       warm=True, warm_rounds=ROUNDS),
                           registry=reg)
    svc.start()
    tiers, outs, reqs = [], [], []
    for i in range(6):
        req = AgreementRequest(kind="run-rounds", n=4, seed=60 + i, rounds=ROUNDS)
        reqs.append(req)
        outs.append(svc.submit(req).result(timeout=300))
        tiers.append(svc.stats()["tier"])
    assert svc.warm_barrier(timeout=300)
    stats = svc.stats()
    svc.stop()
    assert stats["rejected"] == 0 and stats["failed"] == 0
    assert tiers == [0] * len(tiers) and reg.get("serve_shed_tier").value == 0
    for req, out in zip(reqs, outs):
        assert out["decisions"] == _alone(req)[0]
