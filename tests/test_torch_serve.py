"""The port's serving tier (``ba_tpu_torch/runtime/serve.py``) against the
JAX package's (``ba_tpu/runtime/serve.py``), on the CPU.

Two layers, as ``tests/test_serve.py`` has them:

- the host tier: the shed ladder, config and request validation (the
  port's engine tokens ``torch|cuda|auto``), admission closed, the
  bounded queue, shedding interactive work first, the ticket's timeout,
  client fault plans and their ordinals, the committed deadline-storm
  plan;
- the engine-backed tier, on ``engine="torch"`` against the reference's
  ``engine="xla"``: every request's result bit-equal to the reference
  service's for the same request and to its own run alone through the
  port's ``coalesced_sweep`` (plain, scenario, signed and m = 2
  cohorts), batched requests coalesced, the overload path, deadline
  expiry before dispatch against in flight, a fatal cohort failing only
  itself, a transient retried in place, the watchdog's backpressure;
  and the ``request`` record: the reference's key set, its phases
  summing to ``wall_s``.

Tolerance: bit-exact for every decision, count, majority, counter and
leader; latencies are not compared.  Both signing pools are off.  B <= 8,
n <= 8, rounds <= 4.
"""

import json
import time

import numpy as np
import pytest
import torch

from ba_tpu.crypto import pool as j_pool
from ba_tpu.obs.registry import MetricsRegistry as JRegistry
from ba_tpu.runtime import serve as j_serve
from ba_tpu.scenario import from_dict as j_from_dict
from ba_tpu.utils import metrics as j_metrics
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.crypto import pool as t_pool
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.parallel.pipeline import coalesced_sweep
from ba_tpu_torch.runtime import chaos
from ba_tpu_torch.runtime.serve import (
    ENGINE_TOKENS,
    AgreementRequest,
    AgreementService,
    DeadlineExceeded,
    Overloaded,
    RequestFailed,
    ServeConfig,
    ServeError,
    Ticket,
    cohort_key,
    cohort_label,
    shed_tier,
    validate_request,
)
from ba_tpu_torch.scenario import compile as t_compile
from ba_tpu_torch.scenario import spec as t_spec
from ba_tpu_torch.utils import metrics as t_metrics

RESULT_KEYS = ("kind", "rounds", "decisions", "counts", "majorities", "counters", "batch",
               "slot", "leaders")
SPEC_A = {"name": "a", "rounds": 4, "events": [{"round": 1, "kill": [1]}]}
SPEC_B = {"name": "b", "rounds": 4, "events": [
    {"round": 2, "set_faulty": [2], "value": True},
    {"round": 3, "set_strategy": [2], "value": "collude_attack"}]}


@pytest.fixture(scope="module", autouse=True)
def pools_off():
    """Neither package's signing pool starts worker processes here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BA_TPU_SIGN_POOL", "0")
        j_pool.shutdown_defaults()
        mp.setattr(t_pool, "default_workers", lambda: 0)
        t_pool.shutdown_defaults()
        yield
    j_pool.shutdown_defaults()
    t_pool.shutdown_defaults()


def cfg(**kw) -> ServeConfig:
    return ServeConfig(device="cpu", **kw)


def service(config=None, **kw) -> AgreementService:
    return AgreementService(config or cfg(), registry=MetricsRegistry(), **kw)


# -- the host tier -----------------------------------------------------------


def test_shed_tier_ladder():
    c = cfg()
    assert shed_tier(0.0, None, None, c) == 0
    assert shed_tier(0.0, 0.1, 1.0, c) == 0
    assert shed_tier(c.queue_soft_frac, None, None, c) == 1
    assert shed_tier(0.0, c.lag_soft_s, None, c) == 1
    assert shed_tier(0.0, None, float(c.depth), c) == 1
    assert shed_tier(c.queue_hard_frac, None, None, c) == 2
    assert shed_tier(0.0, c.lag_hard_s, None, c) == 2
    assert shed_tier(0.0, float("inf"), None, c) == 2
    assert shed_tier(1.0, None, None, c) == 3
    jc = j_serve.ServeConfig()
    for args in ((0.0, None, None), (0.5, None, None), (0.0, 1.0, None), (0.0, None, 2.0),
                 (0.9, None, None), (0.0, float("inf"), None), (1.0, None, None),
                 (0.2, 0.3, 1.5)):
        assert shed_tier(*args, c) == j_serve.shed_tier(*args, jc), args


def test_serve_config_validate_and_fields():
    for bad in (dict(max_batch=0), dict(max_queue=0), dict(coalesce_window_s=-1.0),
                dict(queue_soft_frac=0.9, queue_hard_frac=0.5),
                dict(lag_soft_s=9.0, lag_hard_s=1.0), dict(engine="xla"),
                dict(engine="pallas"), dict(warm_capacities=(0,)), dict(warm_ms=(True,)),
                dict(max_retries=-1)):
        with pytest.raises(ValueError):
            cfg(**bad)
    # ported since: slo= takes True, a policy path or an SLOPolicy, and
    # compile_ledger= a path
    assert cfg(slo=True).slo is True and cfg(slo="policy.json").slo == "policy.json"
    for bad in (dict(slo=3), dict(slo=object()), dict(compile_ledger=""),
                dict(compile_ledger=7)):
        with pytest.raises(ValueError):
            cfg(**bad)
    with pytest.raises(ValueError, match="aot_cache"):
        cfg(aot_cache="/tmp/x")
    assert ENGINE_TOKENS == ("torch", "cuda", "auto") and cfg().engine == "auto"
    # the reference's knobs, as fields: its BA_TPU_SERVE_RETRIES > BA_TPU_MAX_RETRIES > 3
    assert cfg().resolved_max_retries() == 3
    assert cfg(max_retries=7).resolved_max_retries() == 7
    c = cfg(max_batch=16, max_queue=5, coalesce_window_s=0.25, default_deadline_s=None)
    assert (c.max_batch, c.max_queue, c.coalesce_window_s, c.default_deadline_s) == (
        16, 5, 0.25, None)
    # every other default is the reference's
    ref = j_serve.ServeConfig()
    for name in ("max_batch", "max_queue", "coalesce_window_s", "default_deadline_s",
                 "queue_soft_frac", "queue_hard_frac", "lag_soft_s", "lag_hard_s", "depth",
                 "rounds_per_dispatch", "m", "warm", "warm_capacities", "warm_rounds",
                 "warm_scenarios", "warm_signed", "warm_ms", "burn_soft", "burn_hard"):
        assert getattr(cfg(), name) == getattr(ref, name), name


def test_validate_request_errors():
    validate_request(AgreementRequest())
    for bad in (dict(kind="nope"), dict(order="surrender"), dict(n=0), dict(faulty=(4,)),
                dict(faulty=(True,)), dict(kind="actual-order", rounds=3),
                dict(kind="run-rounds", rounds=0), dict(kind="scenario"),
                dict(kind="run-rounds", spec=object()), dict(engine="xla"), dict(m=0),
                dict(tenant=""), dict(traceparent=5),
                dict(kind="scenario", spec=object(), signed=True)):
        with pytest.raises(ValueError):
            validate_request(AgreementRequest(**bad))
    for engine in ENGINE_TOKENS:
        validate_request(AgreementRequest(engine=engine))
    a = AgreementRequest(kind="actual-order", n=3, seed=1)
    b = AgreementRequest(kind="run-rounds", n=4, seed=2, rounds=1)
    c = AgreementRequest(kind="run-rounds", n=5, seed=3, rounds=1)
    assert cohort_key(a) == cohort_key(b) and cohort_key(c) != cohort_key(b)
    assert cohort_key(AgreementRequest(m=2)) != cohort_key(AgreementRequest())
    assert cohort_key(AgreementRequest(signed=True)) != cohort_key(AgreementRequest())
    assert cohort_key(AgreementRequest(tenant="t")) == cohort_key(AgreementRequest())
    # the labels are the reference's, with the port's engine token
    for req, jreq in ((c, j_serve.AgreementRequest(kind="run-rounds", n=5, seed=3, rounds=1)),
                      (AgreementRequest(kind="run-rounds", rounds=3, m=2, signed=True),
                       j_serve.AgreementRequest(kind="run-rounds", rounds=3, m=2,
                                                signed=True))):
        assert cohort_label(cohort_key(req, "torch")) == cohort_label(
            j_serve.cohort_key(jreq, "xla")).replace(".xla.", ".torch.")


def test_admission_closed_service_rejects():
    svc = service(cfg(max_queue=2))
    with pytest.raises(ServeError):
        svc.submit(AgreementRequest())
    svc.open()
    t = svc.submit(AgreementRequest())
    assert isinstance(t, Ticket) and not t.done()
    svc.stop()
    with pytest.raises(ServeError):
        t.result(timeout=1)
    with pytest.raises(ServeError):
        svc.submit(AgreementRequest())


def test_admission_queue_full_is_bounded_rejection():
    c = cfg(max_queue=3)
    svc = service(c)
    svc.open()
    for i in range(c.max_queue):
        svc.submit(AgreementRequest(kind="run-rounds", seed=i, rounds=2))
    with pytest.raises(Overloaded) as exc:
        svc.submit(AgreementRequest(kind="run-rounds", seed=99, rounds=2))
    assert exc.value.reason == "queue_full" and exc.value.retry_after_s > 0
    for _ in range(10):
        with pytest.raises(Overloaded):
            svc.submit(AgreementRequest(kind="run-rounds", rounds=2))
    assert svc.stats()["queue_depth"] == c.max_queue
    assert svc.stats()["rejected"] == 11
    svc.stop()


def test_admission_sheds_interactive_before_campaigns():
    svc = service(cfg(max_queue=100))
    svc.open()
    spec = t_spec.from_dict({"name": "t", "rounds": 2, "events": []})
    svc._tier = 2
    with pytest.raises(Overloaded) as exc:
        svc.submit(AgreementRequest(kind="run-rounds", rounds=2))
    assert exc.value.reason == "shed_interactive"
    with pytest.raises(Overloaded):
        svc.submit(AgreementRequest(kind="actual-order"))
    svc.submit(AgreementRequest(kind="scenario", spec=spec))
    svc._tier = 3
    with pytest.raises(Overloaded) as exc:
        svc.submit(AgreementRequest(kind="scenario", spec=spec))
    assert exc.value.reason == "shed_all"
    svc.stop()


def test_ticket_result_timeout():
    t = Ticket(AgreementRequest(), 1, None)
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    t._resolve({"x": 1})
    assert t.result(timeout=1) == {"x": 1}


def test_client_fault_plan_round_trip_and_validation():
    doc = {"name": "clients", "faults": [
        {"round": 2, "kind": "slow_client", "seconds": 0.5, "times": 3},
        {"round": 4, "kind": "abandon"},
        {"round": 6, "kind": "deadline_storm"}]}
    plan = chaos.from_dict(doc)
    assert [f.phase for f in plan.faults] == ["client"] * 3
    assert chaos.to_dict(plan) == doc
    for bad in ({"round": 0, "kind": "slow_client"},
                {"round": 0, "kind": "abandon", "seconds": 1.0},
                {"round": 0, "kind": "abandon", "phase": "dispatch"},
                {"round": 0, "kind": "transient", "phase": "client"}):
        with pytest.raises(chaos.FaultPlanError):
            chaos.from_dict({"name": "x", "faults": [bad]})


def test_client_fault_plan_ordinal_consumption():
    plan = chaos.from_dict({"name": "t", "faults": [
        {"round": 1, "kind": "slow_client", "seconds": 0.1, "times": 2},
        {"round": 1, "kind": "abandon"}]})
    inj = chaos.ChaosInjector(plan)
    assert inj.client_faults(0) == []
    assert sorted(f.kind for f in inj.client_faults(1)) == ["abandon", "slow_client"]
    assert [f.kind for f in inj.client_faults(1)] == ["slow_client"]
    assert inj.client_faults(1) == []
    assert len(inj.fired) == 3 and all(f["phase"] == "client" for f in inj.fired)


def test_committed_deadline_storm_plan_is_valid():
    plan = chaos.load("examples/faults/deadline_storm.json")
    assert {f.kind for f in plan.faults} == {"slow_client", "abandon", "deadline_storm"}
    assert all(f.phase == "client" for f in plan.faults)


# -- the engine-backed tier --------------------------------------------------


def _alone(req, rpd=2):
    """The request run alone: one slot through the port's coalesced_sweep
    at its padded capacity, staged as the service stages slot 0."""
    cap = 4
    while cap < req.n:
        cap *= 2
    faulty = np.zeros((1, cap), bool)
    faulty[0, list(req.faulty)] = True
    alive = np.zeros((1, cap), bool)
    alive[0, :req.n] = True
    state = SimState(order=torch.tensor([1 if req.order == "attack" else 0], dtype=torch.int8),
                     leader=torch.zeros(1, dtype=torch.int32), faulty=torch.from_numpy(faulty),
                     alive=torch.from_numpy(alive),
                     ids=torch.arange(1, cap + 1, dtype=torch.int32)[None])
    scenario = None
    if req.kind == "scenario":
        block = t_compile.compile_scenario(req.spec, 1, cap,
                                           ids=np.arange(1, cap + 1, dtype=np.int64))
        scenario = {k: getattr(block, k) for k in t_compile.PLANE_NAMES}
    rounds = req.spec.rounds if req.kind == "scenario" else req.rounds
    out = coalesced_sweep([rng.key(req.seed, device="cpu")], state, rounds, m=req.m or 1,
                          rounds_per_dispatch=rpd, scenario=scenario, signed=req.signed,
                          pool=0, device="cpu")
    res = {"decisions": out["decisions"][:, 0].tolist(),
           "majorities": out["majorities"][0, :req.n].tolist(),
           "counters": dict(zip(out["counter_names"], out["counters"][0].tolist()))}
    if scenario is not None:
        res["leaders"] = out["leaders"][:, 0].tolist()
    return res


MIXED = (  # (kind, order, n, faulty, seed, rounds, spec, m, signed)
    ("run-rounds", "attack", 4, (2,), 11, 4, None, None, False),
    ("run-rounds", "retreat", 3, (), 12, 4, None, None, False),
    ("run-rounds", "attack", 4, (1, 3), 13, 4, None, None, False),
    ("actual-order", "attack", 7, (0, 5), 14, 1, None, None, False),
    ("scenario", "attack", 4, (), 21, 4, SPEC_A, None, False),
    ("scenario", "attack", 4, (3,), 22, 4, SPEC_B, None, False),
    ("run-rounds", "attack", 4, (2,), 31, 3, None, None, True),
    ("run-rounds", "retreat", 4, (0,), 32, 3, None, None, True),
    ("run-rounds", "attack", 8, (1, 6), 41, 2, None, 2, False),
    ("run-rounds", "retreat", 5, (0,), 42, 2, None, 2, False),
)


def _requests(make_req, make_spec):
    return [make_req(kind=k, order=o, n=n, faulty=f, seed=s, rounds=r if k != "scenario" else 1,
                     spec=None if sp is None else make_spec(sp), m=m, signed=sg)
            for k, o, n, f, s, r, sp, m, sg in MIXED]


def _serve_all(svc, reqs):
    svc.open()  # queued before the dispatcher starts: the cohorts are deterministic
    tickets = [svc.submit(r, deadline_s=None) for r in reqs]
    svc.start()
    try:
        return [t.result(timeout=300) for t in tickets]
    finally:
        svc.stop()


@pytest.fixture(scope="module")
def mixed_results():
    port = _serve_all(service(cfg(max_batch=4, max_queue=32, coalesce_window_s=0.01,
                                  rounds_per_dispatch=2)),
                      _requests(AgreementRequest, t_spec.from_dict))
    ref = _serve_all(j_serve.AgreementService(
        j_serve.ServeConfig(max_batch=4, max_queue=32, coalesce_window_s=0.01,
                            rounds_per_dispatch=2, engine="xla"), registry=JRegistry()),
        _requests(j_serve.AgreementRequest, j_from_dict))
    return port, ref


@pytest.mark.parametrize("i", range(len(MIXED)))
def test_service_result_equals_reference_and_alone(mixed_results, i):
    port, ref = mixed_results
    got, want = port[i], ref[i]
    assert {k: got[k] for k in RESULT_KEYS if k in got} == {
        k: want[k] for k in RESULT_KEYS if k in want}
    assert set(got) == set(want)
    assert got["run_id"] == want["run_id"]  # same identity material, same id
    req = _requests(AgreementRequest, t_spec.from_dict)[i]
    alone = _alone(req)
    for key in alone:
        assert got[key] == alone[key], key


def test_serve_batched_requests_bit_exact_and_coalesced():
    svc = service(cfg(max_batch=4, max_queue=16, coalesce_window_s=0.25,
                      rounds_per_dispatch=2))
    svc.start()
    reqs = [AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2],
                             n=(4, 3, 4, 2)[i], faulty=((2,), (), (1,), ())[i], seed=30 + i,
                             rounds=4) for i in range(4)]
    tickets = [svc.submit(r) for r in reqs]
    try:
        outs = [t.result(timeout=300) for t in tickets]
        assert [o["batch"] for o in outs] == [4, 4, 4, 4]
        assert sorted(o["slot"] for o in outs) == [0, 1, 2, 3]
        for req, out in zip(reqs, outs):
            alone = _alone(req)
            assert out["decisions"] == alone["decisions"]
            assert out["counters"] == alone["counters"]
            assert out["run_id"].startswith("run-")
    finally:
        svc.stop()


def test_a_burst_wakes_the_dispatcher_once_a_window():
    """One client thread submitting a burst of max_batch requests fills
    one cohort and wakes the waiting dispatcher twice (the first request
    opens the window, the last fills it), not once a request."""
    import threading

    class Counting(threading.Condition):
        notifies = 0

        def notify_all(self):
            Counting.notifies += 1
            super().notify_all()

    svc = service(cfg(max_batch=8, max_queue=16, coalesce_window_s=5.0,
                      rounds_per_dispatch=2))
    svc._cond = Counting()
    svc.start()
    time.sleep(0.1)  # the dispatcher idles on the condition
    reqs = [AgreementRequest(kind="run-rounds", n=4, faulty=(2,), seed=60 + i, rounds=2)
            for i in range(8)]
    try:
        t0 = time.perf_counter()
        tickets = []
        for r in reqs:
            tickets.append(svc.submit(r))
            time.sleep(0.002)  # the dispatcher may run between submissions
        outs = [t.result(timeout=300) for t in tickets]
        assert [o["batch"] for o in outs] == [8] * 8
        assert Counting.notifies <= 2
        assert time.perf_counter() - t0 < 5.0  # the full cohort did not wait out the window
    finally:
        svc.stop()


def test_overload_path_deterministic_no_deadlock():
    c = cfg(max_batch=4, max_queue=4, coalesce_window_s=0.05, rounds_per_dispatch=2)
    svc = service(c)
    svc.open()
    tickets = [svc.submit(AgreementRequest(kind="run-rounds", seed=40 + i, rounds=2))
               for i in range(c.max_queue)]
    with pytest.raises(Overloaded):
        svc.submit(AgreementRequest(kind="run-rounds", rounds=2))
    svc.start()
    outs = [t.result(timeout=300) for t in tickets]
    assert all(sum(o["counts"].values()) == 2 for o in outs)
    st = svc.stats()
    assert st["completed"] == 4 and st["rejected"] == 1 and st["queue_depth"] == 0
    svc.stop()
    assert not svc.running()


def test_deadline_expiry_before_dispatch_vs_in_flight():
    plan = chaos.from_dict({"name": "slow", "faults": [
        {"round": 0, "kind": "stall", "phase": "dispatch", "seconds": 0.4}]})
    svc = service(cfg(max_batch=2, max_queue=8, coalesce_window_s=0.001,
                      rounds_per_dispatch=2), fault_plan=plan)
    svc.open()
    dead = svc.submit(AgreementRequest(kind="run-rounds", seed=50, rounds=2), deadline_s=0.0)
    svc.start()
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=60)
    t0 = time.perf_counter()
    late = svc.submit(AgreementRequest(kind="run-rounds", seed=51, rounds=2), deadline_s=0.15)
    out = late.result(timeout=60)
    assert time.perf_counter() - t0 >= 0.35
    assert out["counts"] and svc.stats()["expired"] == 1
    svc.stop()


def test_cohort_fatal_fails_only_its_cohort():
    plan = chaos.from_dict({"name": "one-fatal", "faults": [{"round": 0, "kind": "fatal"}]})
    svc = service(cfg(max_batch=2, max_queue=8, coalesce_window_s=0.02,
                      rounds_per_dispatch=2), fault_plan=plan)
    svc.open()
    doomed_req = AgreementRequest(kind="run-rounds", seed=60, rounds=4)
    doomed = svc.submit(doomed_req)
    bystander_req = AgreementRequest(kind="run-rounds", seed=61, rounds=2)
    bystander = svc.submit(bystander_req)
    svc.start()
    with pytest.raises(RequestFailed) as exc:
        doomed.result(timeout=300)
    assert exc.value.fault == "fatal"
    assert bystander.result(timeout=300)["decisions"] == _alone(bystander_req)["decisions"]
    retry = svc.submit(doomed_req).result(timeout=300)
    assert retry["decisions"] == _alone(doomed_req)["decisions"]
    st = svc.stats()
    assert st["failed"] == 1 and st["completed"] == 2 and st["injected"] == 1
    svc.stop()


def test_serve_transient_retry_in_place():
    plan = chaos.from_dict({"name": "flaky", "faults": [
        {"round": 0, "kind": "transient", "times": 2}]})
    svc = service(cfg(max_batch=2, max_queue=8, coalesce_window_s=0.001,
                      rounds_per_dispatch=2), fault_plan=plan)
    svc.start()
    req = AgreementRequest(kind="run-rounds", seed=70, rounds=2)
    assert svc.submit(req).result(timeout=300)["decisions"] == _alone(req)["decisions"]
    st = svc.stats()
    assert st["retries"] == 2 and st["failed"] == 0
    svc.stop()


def test_dispatch_watchdog_wedge_applies_backpressure():
    plan = chaos.from_dict({"name": "wedge", "faults": [
        {"round": 0, "kind": "stall", "phase": "dispatch", "seconds": 1.0}]})
    svc = service(cfg(max_batch=2, max_queue=8, coalesce_window_s=0.001,
                      rounds_per_dispatch=2, dispatch_timeout_s=0.2), fault_plan=plan)
    svc.open()
    req = AgreementRequest(kind="run-rounds", seed=80, rounds=2)
    wedged = svc.submit(req)
    svc.start()
    time.sleep(0.6)
    assert svc.stats()["tier"] == 3
    with pytest.raises(Overloaded) as exc:
        svc.submit(AgreementRequest(kind="run-rounds", seed=81, rounds=2))
    assert exc.value.reason == "shed_all"
    assert wedged.result(timeout=60)["decisions"] == _alone(req)["decisions"]
    later = None
    for _ in range(200):
        try:
            later = svc.submit(AgreementRequest(kind="run-rounds", seed=82, rounds=2))
            break
        except Overloaded:
            time.sleep(0.05)
    assert later is not None, "tier never decayed after the wedge"
    later.result(timeout=60)
    assert svc.stats()["stalls"] == 1
    svc.stop()


# -- records -----------------------------------------------------------------


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_request_record_keys_and_phases(tmp_path):
    req_args = dict(kind="run-rounds", n=4, faulty=(2,), seed=90, rounds=4, tenant="t1")
    t_metrics.configure(str(tmp_path / "port.jsonl"))
    try:
        _serve_all(service(cfg(max_batch=2, rounds_per_dispatch=2)),
                   [AgreementRequest(**req_args)])
    finally:
        t_metrics.configure(None)
    j_metrics.configure(str(tmp_path / "ref.jsonl"))
    try:
        _serve_all(j_serve.AgreementService(
            j_serve.ServeConfig(max_batch=2, rounds_per_dispatch=2, engine="xla"),
            registry=JRegistry()), [j_serve.AgreementRequest(**req_args)])
    finally:
        j_metrics.configure(None)
    port = [r for r in _records(tmp_path / "port.jsonl") if r["event"] == "request"]
    ref = [r for r in _records(tmp_path / "ref.jsonl") if r["event"] == "request"]
    assert len(port) == len(ref) == 1
    assert set(port[0]) == set(ref[0])
    rec = port[0]
    assert rec["status"] == "ok" and rec["tenant"] == "t1"
    assert rec["cohort"] == ref[0]["cohort"].replace(".xla.", ".auto.")
    phases = sum(rec[k] for k in ("queue_s", "coalesce_s", "compile_s", "dispatch_s",
                                  "retire_lag_s"))
    assert abs(phases - rec["wall_s"]) <= 1e-5
    spans = [r for r in _records(tmp_path / "port.jsonl") if r["event"] == "flight_span"]
    assert [(s["lo"], s["hi"]) for s in spans] == [(0, 2), (2, 4)]
    assert {s["run_id"] for s in spans} == {rec["run_id"]}


def test_no_file_without_a_sink(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not t_metrics.default_sink().enabled
    _serve_all(service(cfg(rounds_per_dispatch=2)),
               [AgreementRequest(kind="run-rounds", seed=1, rounds=2)])
    assert list(tmp_path.iterdir()) == []


def test_handoff_detaches_queued_tickets():
    """The drain hook: queued tickets fail with a re-homing ServeError, are
    not counted as failures and emit no record; admission closes."""
    svc = service(cfg(max_queue=8))
    svc.open()
    tickets = [svc.submit(AgreementRequest(kind="run-rounds", seed=i, rounds=2))
               for i in range(3)]
    assert svc.handoff(timeout=5) == tickets
    for t in tickets:
        with pytest.raises(ServeError, match="re-homed"):
            t.result(timeout=1)
    st = svc.stats()
    assert st["failed"] == 0 and st["queue_depth"] == 0 and not st["open"]
    with pytest.raises(ServeError):
        svc.submit(AgreementRequest())
