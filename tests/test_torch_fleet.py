"""The port's elastic fleet (``ba_tpu_torch/fleet/``) on the CPU, against
the JAX package's (``ba_tpu/fleet/``) where the two meet.

The layer without an engine: the hash ring (the reference's points, so a
cohort has one home in both packages, and minimal movement), keyword-only
``FleetConfig`` validation, the ``CampaignSpec`` doc, the ledger fold, the
handoff grammar, the serve-side handoff, the warm ring-entry gate, the
router's hops and rehoming, an empty drain, and the REPL's ``fleet``
command against the reference REPL's lines.  The engine: the drill (drain
a replica mid-campaign under routed load, then kill one and adopt its
orphan), each migrated campaign bit-equal to an uninterrupted
``supervised_sweep``; and a handoff written by the reference's
``write_handoff`` over the reference's checkpoints verifies and resumes in
a port replica, bit-equal to the reference's own run."""

import json
import os
import threading
import time

import numpy as np
import pytest

from ba_tpu.fleet import HashRing as JHashRing
from ba_tpu.fleet import write_handoff as j_write_handoff
from ba_tpu.fleet.router import _point as j_point
from ba_tpu_torch.core import rng
from ba_tpu_torch.fleet import (
    CampaignSpec,
    FleetConfig,
    FleetRouter,
    HandoffRefused,
    HashRing,
    ReplicaManager,
    read_handoff,
    read_ledger,
    resume_handoff,
    verify_handoff,
    write_handoff,
)
from ba_tpu_torch.fleet.router import _point
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.parallel.sweep import make_sweep_state
from ba_tpu_torch.runtime.serve import (
    AgreementRequest,
    AgreementService,
    ServeConfig,
    ServeError,
)
from ba_tpu_torch.runtime.supervisor import SupervisorConfig, supervised_sweep

CPU_SERVE = dict(device="cpu", warm=False)
B, CAP, SEED, STATE_SEED = 8, 4, 11, 12


def _uninterrupted(rounds, rounds_per_dispatch=1):
    return supervised_sweep(rng.key(SEED, "cpu"), make_sweep_state(rng.key(STATE_SEED, "cpu"),
                                                                   B, CAP),
                            rounds, rounds_per_dispatch=rounds_per_dispatch,
                            collect_decisions=True, config=SupervisorConfig(timeout_s=60.0),
                            device="cpu")


# -- the layer without an engine ----------------------------------------------


def test_hash_ring_matches_the_reference_with_minimal_movement():
    assert _point("replica-0", 0) == j_point("replica-0", 0) == 17044263878877797094
    members = ["replica-0", "replica-1", "replica-2"]
    a = HashRing(members, vnodes=64)
    b = HashRing(reversed(members), vnodes=64)
    ref = JHashRing(members, vnodes=64)
    keys = [f"plain.r{r}.c{c}.{e}.m1" for r in (1, 2, 4, 8, 16, 32) for c in (4, 1024)
            for e in ("auto", "cuda", "torch")]
    for k in keys:
        assert a.prefer(k) == b.prefer(k) == ref.prefer(k)
        assert sorted(a.prefer(k)) == sorted(members)
    small = HashRing(["replica-0", "replica-2"], vnodes=64)
    for k in keys:
        if a.prefer(k)[0] != "replica-1":
            assert small.prefer(k)[0] == a.prefer(k)[0]
    assert HashRing((), vnodes=64).prefer("anything") == []
    with pytest.raises(ValueError):
        HashRing(members, vnodes=0)


def test_fleet_config_is_keywords_only_and_validated():
    for bad in (dict(replicas=0), dict(max_hops=0), dict(vnodes=0),
                dict(replicas=4, max_replicas=2)):
        with pytest.raises(ValueError):
            FleetConfig(**bad)
    cfg = FleetConfig(replicas=3, max_hops=2, vnodes=16, root="fleet")
    assert (cfg.replicas, cfg.max_hops, cfg.vnodes, cfg.root) == (3, 2, 16, "fleet")
    with pytest.raises(TypeError):
        FleetConfig(3)
    assert not hasattr(FleetConfig, "from_env")


def test_campaign_spec_doc_roundtrip_and_validation():
    spec = CampaignSpec(campaign="c1", seed=11, state_seed=12, batch=8, rounds=64)
    doc = spec.to_doc()
    assert "scenario" not in doc and CampaignSpec.from_doc(doc) == spec
    assert json.loads(json.dumps(doc)) == doc
    with pytest.raises(ValueError):
        CampaignSpec.from_doc({**doc, "surprise": 1})
    with pytest.raises(ValueError):
        CampaignSpec.from_doc("not a dict")
    for bad in ("", "a/b", "..", "x\x00y"):
        with pytest.raises(ValueError):
            CampaignSpec(campaign=bad, seed=1, state_seed=2, batch=4, rounds=8)
    with pytest.raises(ValueError):
        CampaignSpec(campaign="c", seed=1, state_seed=2, batch=0, rounds=8)


def test_read_ledger_folds_statuses(tmp_path):
    from ba_tpu.fleet import read_ledger as j_read_ledger

    root = str(tmp_path)
    path = os.path.join(root, "replicas", "replica-0", "ledger.jsonl")
    os.makedirs(os.path.dirname(path))
    rows = [
        {"ev": "admit", "campaign": "done1", "doc": {"d": 1}, "template": "t1"},
        {"ev": "checkpoint", "campaign": "done1", "fingerprint": "fp1"},
        {"ev": "done", "campaign": "done1"},
        {"ev": "admit", "campaign": "handed", "doc": {"d": 2}, "template": "t2"},
        {"ev": "handoff", "campaign": "handed"},
        {"ev": "admit", "campaign": "orphan", "doc": {"d": 3}, "template": "t3"},
        {"ev": "checkpoint", "campaign": "orphan", "fingerprint": "fp3"},
    ]
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
        f.write('{"ev": "checkpoint", "campaign": "orp')
    got = read_ledger(root, "replica-0")
    assert got == j_read_ledger(root, "replica-0")
    by_id = {e["campaign"]: e for e in got}
    assert [by_id[c]["status"] for c in ("done1", "handed", "orphan")] == \
        ["done", "handoff", "orphaned"]
    assert by_id["orphan"]["fingerprint"] == "fp3" and by_id["orphan"]["template"] == "t3"
    assert read_ledger(root, "never-wrote") == []


def test_handoff_header_grammar_matches_the_reference(tmp_path):
    kw = dict(campaign="c1", doc={"campaign": "c1"}, template=str(tmp_path / "ck_{round}.npz"),
              round_cursor=32, rounds=64, checkpoint=str(tmp_path / "ck_32.npz"),
              fingerprint="fp", signed=False, from_replica="replica-0")
    path, j_path = str(tmp_path / "handoff.json"), str(tmp_path / "j_handoff.json")
    header = write_handoff(path, **kw)
    assert j_write_handoff(j_path, **kw) == header
    assert open(path).read() == open(j_path).read()
    assert read_handoff(path) == header == read_handoff(j_path)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w", encoding="utf-8") as f:
        f.write("not json")
    with pytest.raises(HandoffRefused):
        read_handoff(bad)
    with pytest.raises(HandoffRefused):
        read_handoff(str(tmp_path / "missing.json"))
    for mutate in ({"format": "other"}, {"v": 99}):
        with open(bad, "w", encoding="utf-8") as f:
            json.dump({**header, **mutate}, f)
        with pytest.raises(HandoffRefused):
            read_handoff(bad)
    incomplete = dict(header)
    del incomplete["fingerprint"]
    with open(bad, "w", encoding="utf-8") as f:
        json.dump(incomplete, f)
    with pytest.raises(HandoffRefused, match="fingerprint"):
        read_handoff(bad)
    with pytest.raises(HandoffRefused, match="failed validation"):
        verify_handoff(header)


def test_serve_handoff_rehomes_without_counting_failures():
    reg = MetricsRegistry()
    svc = AgreementService(ServeConfig(max_queue=8, **CPU_SERVE), registry=reg)
    svc.open()
    tickets = [svc.submit(AgreementRequest(kind="run-rounds", n=4, seed=i, rounds=2),
                          deadline_s=None) for i in range(3)]
    rehomed = svc.handoff()
    assert [t.id for t in rehomed] == [t.id for t in tickets]
    for t in tickets:
        with pytest.raises(ServeError, match="re-homed"):
            t.result(timeout=1.0)
    assert svc.stats()["failed"] == 0 and reg.counter("serve_failed_total").value == 0
    with pytest.raises(ServeError):
        svc.submit(AgreementRequest(kind="run-rounds", rounds=2))


def test_warm_ok_is_the_ring_entry_gate():
    from ba_tpu_torch.runtime.warmup import WarmupRunner

    runner = WarmupRunner(None, [], registry=MetricsRegistry())
    assert not runner.ok()
    runner._done.set()
    assert runner.ok()
    runner.errors = 1
    assert not runner.ok()


def _admission_only_fleet(serve_config, replicas=2, **cfg):
    """Replicas that admit and never dispatch (no dispatcher thread)."""
    mgr = ReplicaManager(FleetConfig(replicas=replicas, **cfg), serve_config=serve_config)
    for _ in range(replicas):
        rep = mgr._new_replica()
        rep.service.open()
        rep.set_state("ready")
    return mgr


def test_router_routes_by_cohort_and_bounds_hops():
    mgr = _admission_only_fleet(ServeConfig(max_queue=4, **CPU_SERVE))
    router = FleetRouter(mgr)
    req = AgreementRequest(kind="run-rounds", n=4, seed=1, rounds=2)
    t = router.submit(req, deadline_s=None)
    assert t.admit_hops == 1 and t.reroutes == 0
    assert {router.submit(req, deadline_s=None).replica for _ in range(3)} == {t.replica}
    # the home is the reference ring's home for the same members
    from ba_tpu_torch.runtime.serve import cohort_key, cohort_label

    assert t.replica == JHashRing(["replica-0", "replica-1"]).prefer(
        cohort_label(cohort_key(req)))[0]
    with pytest.raises(ServeError, match="no ready replica"):
        FleetRouter(ReplicaManager(FleetConfig(replicas=1))).submit(req, deadline_s=None)
    stats = router.stats()
    assert stats["routes"] == 4 and stats["ready"] == 2


def test_router_hops_off_overloaded_home_and_carries_the_origin_retry_after():
    from ba_tpu_torch.runtime.serve import Overloaded

    mgr = _admission_only_fleet(ServeConfig(max_queue=8, **CPU_SERVE))
    router = FleetRouter(mgr)
    req = AgreementRequest(kind="run-rounds", n=4, seed=1, rounds=2)
    home = router.submit(req, deadline_s=None).replica
    mgr.get(home).service._tier = 3
    routed = router.submit(req, deadline_s=None)
    assert routed.replica != home and routed.admit_hops == 2
    for rep in mgr.all():
        rep.service._tier = 3
    with pytest.raises(Overloaded) as shed:
        router.submit(req, deadline_s=None)
    with pytest.raises(Overloaded) as origin:
        mgr.get(home).submit(req, deadline_s=None)
    assert shed.value.retry_after_s == origin.value.retry_after_s


def test_routed_ticket_rehomes_off_a_draining_replica():
    mgr = _admission_only_fleet(ServeConfig(max_queue=8, **CPU_SERVE))
    router = FleetRouter(mgr)
    routed = router.submit(AgreementRequest(kind="run-rounds", n=4, seed=1, rounds=2),
                           deadline_s=None)
    home = routed.replica
    mgr.get(home).service.handoff()
    mgr.get(home).set_state("stopped")
    with pytest.raises(TimeoutError):
        routed.result(timeout=0.5)
    assert routed.reroutes == 1 and routed.replica != home
    assert routed.tried == [home, routed.replica]
    assert router.stats()["reroutes"] == 1
    survivor = routed.replica
    mgr.get(survivor).service.handoff()
    mgr.get(survivor).set_state("stopped")
    with pytest.raises(ServeError, match="no surviving replica"):
        routed.result(timeout=5.0)


def test_a_drained_backlog_reaches_the_survivor_at_once():
    """The port re-homes when the replica fails a ticket, not at the
    caller's next wait (the reference's way, which trickles a backlog in
    one ticket a client): every queued ticket is on the survivor before
    any caller waits."""
    mgr = _admission_only_fleet(ServeConfig(max_queue=64, **CPU_SERVE))
    router = FleetRouter(mgr)
    routed = [router.submit(AgreementRequest(kind="run-rounds", n=4, seed=i, rounds=2),
                            deadline_s=None) for i in range(12)]
    home = routed[0].replica
    assert {r.replica for r in routed} == {home}
    mgr.get(home).set_state("draining")
    mgr.get(home).service.handoff()
    survivor = [r for r in mgr.all() if r.name != home][0]
    assert survivor.health()["queue_depth"] == 12
    assert all(r.reroutes == 1 and r.replica == survivor.name for r in routed)
    assert router.stats()["reroutes"] == 12
    with pytest.raises(TimeoutError):  # admission only: nobody dispatches
        routed[0].result(timeout=0.2)
    assert routed[0].reroutes == 1


def test_drain_zero_campaigns_is_strict_noop(tmp_path):
    root = str(tmp_path / "fleet")
    mgr = ReplicaManager(FleetConfig(replicas=2, root=root), serve_config=ServeConfig(**CPU_SERVE))
    mgr.start()
    assert [r.state for r in mgr.all()] == ["ready", "ready"]
    assert mgr.drain("replica-0") == []
    assert mgr.get("replica-0").state == "stopped"
    assert not os.path.exists(os.path.join(root, "campaigns"))
    assert [f for _, _, files in os.walk(root) for f in files if f != "ledger.jsonl"] == []
    assert FleetRouter(mgr).stats()["ready"] == 1
    mgr.stop()


def test_repl_fleet_command_prints_the_reference_lines(tmp_path):
    from ba_tpu.runtime.backends import PyBackend as JPyBackend
    from ba_tpu.runtime.cluster import Cluster as JCluster
    from ba_tpu.runtime.repl import handle_command as j_handle
    from ba_tpu_torch.runtime.backends import TorchBackend
    from ba_tpu_torch.runtime.cluster import Cluster
    from ba_tpu_torch.runtime.repl import handle_command

    ours, theirs = Cluster(4, TorchBackend(device="cpu"), seed=0), JCluster(4, JPyBackend(),
                                                                            seed=0)
    script = ["fleet", "fleet stat", "fleet start replicas=two", "fleet start replicas=0",
              "fleet start hops=x", "fleet start bogus", "fleet start replicas=2 root=ROOT queue=4",
              "fleet start replicas=1", "fleet stat", "fleet drain nope", "fleet drain",
              "fleet drain replica-0", "fleet stat", "fleet stop", "fleet stop"]
    got, want = [], []
    for line in script:
        handle_command(ours, line.replace("ROOT", str(tmp_path / "ours")), got.append)
        j_handle(theirs, line.replace("ROOT", str(tmp_path / "theirs")), want.append)
    assert [ln.replace(str(tmp_path / "theirs"), str(tmp_path / "ours")) for ln in want] == got
    assert "fleet: drained replica-0 — 0 campaign(s) migrated, 1 replica(s) still serving" \
        in got
    assert got[-2] == "fleet: stopped — routes=0, reroutes=0"
    assert ours._fleet_manager is None


# -- the engine ---------------------------------------------------------------


def _spawn_clients(router, n, seed0):
    results = {}

    def client(i):
        t = router.submit(AgreementRequest(kind="run-rounds", n=4, seed=seed0 + i, rounds=2),
                          deadline_s=None)
        results[i] = t.result(timeout=120)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    return threads, results


def _join_all(threads):
    for t in threads:
        t.join(120)
    return sum(t.is_alive() for t in threads)


def test_fleet_drill_drain_resume_and_kill_adopt(tmp_path):
    rounds = 400
    want = _uninterrupted(rounds)
    root = str(tmp_path / "fleet")
    mgr = ReplicaManager(FleetConfig(replicas=2, root=root),
                         serve_config=ServeConfig(max_queue=16, coalesce_window_s=0.01,
                                                  **CPU_SERVE))
    mgr.start()
    router = FleetRouter(mgr)

    def start_campaign(replica, cid):
        handle = mgr.get(replica).run_campaign(CampaignSpec(
            campaign=cid, seed=SEED, state_seed=STATE_SEED, batch=B, rounds=rounds,
            capacity=CAP, checkpoint_every=8))
        deadline = time.perf_counter() + 60
        while handle.fingerprint is None and not handle.done():
            assert time.perf_counter() < deadline, "no first checkpoint"
            time.sleep(0.01)
        return handle

    h1 = start_campaign("replica-1", "c1")
    threads, results = _spawn_clients(router, 8, seed0=0)
    adopted = mgr.drain("replica-1")
    assert h1.outcome == "handoff", (h1.outcome, h1.error)
    header = read_handoff(h1.handoff_path)
    verify_handoff(header)
    with pytest.raises(HandoffRefused, match="cross-protocol"):
        verify_handoff({**header, "signed": not header["signed"]})
    with pytest.raises(HandoffRefused, match="fingerprint"):
        verify_handoff({**header, "fingerprint": "0" * 64})
    assert _join_all(threads) == 0, "hung client through drain"
    assert len(results) == 8 and all(isinstance(r, dict) for r in results.values())
    (h2,) = adopted
    assert h2.wait(240) and h2.outcome == "completed", (h2.outcome, h2.error)
    np.testing.assert_array_equal(h2.result["decisions"], want["decisions"])
    np.testing.assert_array_equal(h2.result["histograms"], want["histograms"])
    assert h2.result["supervisor"]["history_start"] == 0

    mgr.start_replica()
    h3 = start_campaign("replica-0", "c2")
    threads2, results2 = _spawn_clients(router, 8, seed0=100)
    mgr.kill("replica-0")
    assert h3.wait(120) and h3.outcome == "abandoned", h3.outcome
    assert h3.handoff_path is None
    assert {e["campaign"]: e["status"] for e in read_ledger(root, "replica-0")}["c2"] == \
        "orphaned"
    assert _join_all(threads2) == 0, "hung client through kill"
    assert all(isinstance(r, dict) for r in results2.values())
    (h4,) = mgr.adopt_orphans("replica-0")
    assert h4.wait(240) and h4.outcome == "completed", (h4.outcome, h4.error)
    np.testing.assert_array_equal(h4.result["decisions"], want["decisions"])
    assert h4.result["supervisor"]["history_start"] == 0
    assert router.stats()["routes"] == 16
    mgr.stop()


def test_a_reference_handoff_verifies_and_resumes_in_a_port_replica(tmp_path):
    """The reference's supervised campaign, stopped at its round-16
    checkpoint, handed off with the reference's ``write_handoff``; a port
    replica verifies the header and completes the campaign bit-equal to
    the reference's uninterrupted run."""
    import jax.random as jr

    from ba_tpu.fleet import CampaignSpec as JCampaignSpec
    from ba_tpu.parallel import make_sweep_state as j_make_sweep_state
    from ba_tpu.runtime import supervisor as j_sup
    from ba_tpu.utils import snapshot as j_snapshot

    rounds = 48
    spec = CampaignSpec(campaign="c9", seed=SEED, state_seed=STATE_SEED, batch=B,
                        rounds=rounds, capacity=CAP, checkpoint_every=8)
    root = str(tmp_path / "fleet")
    directory = os.path.join(root, "campaigns", spec.campaign)
    os.makedirs(directory)
    template = os.path.join(directory, "ck_{round}.npz")

    class Stop(BaseException):
        pass

    def stop_at_16(round_cursor, path):
        if round_cursor >= 16:
            raise Stop

    def ref(**kw):
        return j_sup.supervised_sweep(
            jr.key(SEED), j_make_sweep_state(jr.key(STATE_SEED), B, CAP), rounds,
            rounds_per_dispatch=1, collect_decisions=True,
            config=j_sup.SupervisorConfig(timeout_s=60.0), engine="xla", **kw)

    with pytest.raises(Stop):
        ref(checkpoint_every=8, checkpoint_path=template, on_checkpoint=stop_at_16)
    ck = template.replace("{round}", "16")
    meta = j_snapshot.validate_carry_checkpoint(ck)
    path = os.path.join(directory, "handoff.json")
    j_write_handoff(path, campaign=spec.campaign,
                    doc=JCampaignSpec.from_doc(spec.to_doc()).to_doc(), template=template,
                    round_cursor=16, rounds=rounds, checkpoint=ck,
                    fingerprint=meta["campaign_sha256"], signed=bool(meta.get("signed")),
                    from_replica="jax-replica", run_id=meta.get("run_id"))
    assert verify_handoff(read_handoff(path))["campaign_sha256"] == meta["campaign_sha256"]
    mgr = ReplicaManager(FleetConfig(replicas=1, root=root), serve_config=ServeConfig(**CPU_SERVE))
    mgr.start()
    try:
        handle = resume_handoff(path, mgr.get("replica-0"))
        assert handle.wait(240) and handle.outcome == "completed", (handle.outcome,
                                                                     handle.error)
    finally:
        mgr.stop()
    want = ref()
    np.testing.assert_array_equal(handle.result["decisions"], np.asarray(want["decisions"]))
    np.testing.assert_array_equal(handle.result["histograms"], np.asarray(want["histograms"]))
    assert handle.result["supervisor"]["history_start"] == 0
    assert handle.result["supervisor"]["run_id"] == want["supervisor"]["run_id"]
