"""Host-side cluster: membership registry, election-for-life, fault flags
(``ba_tpu/runtime/cluster.py``).

The stateful shell around the pure consensus core, in place of the
reference's thread-per-general runtime (ba.py:66-122, 344-351).  Threads,
sockets and 0.1 s polling loops are gone; their semantics stay:

- Generals get ascending ids from 1 and "ports" from 18812 (ba.py:344-351);
  the ports are only displayed (there is no TCP).
- Election is for life, by lowest id among the living (ba.py:124-157): the
  leader changes only when it is killed, detected by an event-driven
  ``tick()`` after every membership change.
- New generals adopt the existing leader (ba.py:86-102).
- Killed generals leave the roster (ba.py:415-425).

The JAX package's emit points are kept: ``failover_kill`` and
``election`` instants with the ``failover_kills_total`` /
``elections_total`` counters, the ``agreement_round`` /
``agreement_rounds`` / ``scenario_campaign`` spans (``round_wall_s``), and
the ``agreement_round``, ``pipeline_dispatch``,
``agreement_rounds_pipelined`` and ``scenario_campaign`` records.  They
write nothing unless the tracer or the metrics sink is configured, so the
REPL's stdout is the same with them.
"""

from __future__ import annotations

import dataclasses
import time

from ba_tpu_torch import obs
from ba_tpu_torch.core.quorum import quorum_threshold_py
from ba_tpu_torch.core.types import ATTACK, COMMAND_NAMES, RETREAT, UNDEFINED, command_from_name
from ba_tpu_torch.utils import metrics

BASE_PORT = 18812  # rpyc's default port, kept for display parity (ba.py:355)


@dataclasses.dataclass
class General:
    """Roster entry — the host-visible face of one general."""

    id: int
    port: int
    faulty: bool = False
    alive: bool = True


@dataclasses.dataclass
class RoundResult:
    """Everything ``actual-order`` needs to print (ba.py:383-399)."""

    per_general: list  # (id, is_primary, majority_str, faulty)
    nr_faulty: int
    n_attack: int
    n_retreat: int
    n_undefined: int
    needed: int
    total: int
    decision: str  # "attack" | "retreat" | "undefined"


class Cluster:
    """B = 1 interactive cluster with elastic membership.

    ``backend`` provides ``run_round(generals, leader_idx, order_code,
    seed) -> list[int]``, each roster general's majority code, and
    optionally ``run_rounds`` and ``run_scenario``.
    """

    def __init__(self, n: int, backend, seed: int = 0):
        self.backend = backend
        self.seed = seed
        self._round = 0
        self.generals: list[General] = []
        self._next_id = 1
        self.leader_id: int | None = None
        self.add(n)

    # -- membership ---------------------------------------------------------

    def add(self, count: int) -> None:
        """Spawn ``count`` generals with the next ids and ports
        (ba.py:427-437).  Joiners adopt the current leader; a cluster
        without one elects one."""
        for _ in range(count):
            gid = self._next_id
            self._next_id += 1
            self.generals.append(General(id=gid, port=BASE_PORT + gid - 1))
        self.tick()

    def kill(self, gid: int) -> bool:
        """Kill by id (ba.py:415-425). Returns False if no such general."""
        g = self.find(gid)
        if g is None or not g.alive:
            return False
        g.alive = False
        # a marker and a counter, not a record: the stream keeps one
        # record a round
        obs.instant("failover_kill", gid=gid, was_leader=gid == self.leader_id)
        obs.default_registry().counter("failover_kills_total").inc()
        self.generals = [x for x in self.generals if x.alive]
        self.tick()
        return True

    def set_faulty(self, gid: int, faulty: bool) -> bool:
        """Live fault injection (``g-state <id> faulty``, ba.py:401-407)."""
        g = self.find(gid)
        if g is None:
            return False
        g.faulty = faulty
        return True

    def find(self, gid: int):
        for g in self.generals:
            if g.id == gid:
                return g
        return None

    def tick(self) -> None:
        """Failure detection and election, event-driven: a living leader
        is never displaced (ba.py:124-125); a dead one is replaced by the
        lowest living id.  An election (not a drain to no leader) is
        counted."""
        prev = self.leader_id
        alive = [g for g in self.generals if g.alive]
        if not alive:
            self.leader_id = None
        elif self.leader_id is None or self.find(self.leader_id) is None:
            self.leader_id = min(g.id for g in alive)
        if self.leader_id != prev and self.leader_id is not None:
            _elected(self.leader_id, prev)

    @property
    def leader(self):
        return self.find(self.leader_id) if self.leader_id is not None else None

    def _leader_idx(self) -> int:
        return next(i for i, g in enumerate(self.generals) if g.id == self.leader_id)

    # -- the agreement round ------------------------------------------------

    def actual_order(self, command: str) -> RoundResult | None:
        """One full agreement round: the ``actual-order`` hot path.

        String-parity quirk: the reference ships the raw command string,
        so the leader's reported majority is that raw string even when it
        is neither "attack" nor "retreat" (ba.py:284-285), and the quorum
        then buckets it as undefined (ba.py:208-215).  Lieutenants only
        ever see attack / retreat (ba.py:163-167).
        """
        if not self.generals:
            return None  # the reference would crash here (SURVEY.md Q4)
        self.tick()
        leader_idx = self._leader_idx()
        with obs.timed_span("agreement_round", obs.default_registry().histogram("round_wall_s"),
                            round=self._round, n=len(self.generals)) as timed:
            majorities = self.backend.run_round(
                self.generals, leader_idx, command_from_name(command), self._round_seed()
            )
        round_idx = self._round
        self._round += 1
        res = self._tally(command, leader_idx, majorities)
        metrics.emit({
            "event": "agreement_round", "round": round_idx, "n": len(self.generals),
            "leader_id": self.leader_id, "order": command, "decision": res.decision,
            "n_attack": res.n_attack, "n_retreat": res.n_retreat,
            "n_undefined": res.n_undefined, "needed": res.needed, "total": res.total,
            "nr_faulty": res.nr_faulty, "round_elapsed_s": round(timed.elapsed_s, 6),
        })
        return res

    def actual_order_rounds(self, command: str, rounds: int):
        """``rounds`` agreement rounds in one pipelined device run.

        Backends with ``run_rounds`` run all R rounds through the
        pipelined sweep engine; backends without it (the Python oracle),
        protocols it cannot pipeline (unsigned SM) and non-canonical
        orders fall back to R sequential ``actual_order`` calls.

        Returns ``(last RoundResult, counts, stats)``: the final round's
        result, a ``{"attack": a, "retreat": r, "undefined": u}`` count of
        the R quorum decisions, and the engine's stats (None on the
        sequential path).  None when the cluster is empty.
        """
        if rounds < 1:
            raise ValueError(f"rounds={rounds} must be >= 1")
        if not self.generals:
            return None  # the reference would crash here (SURVEY.md Q4)
        self.tick()
        leader_idx = self._leader_idx()
        run_rounds = getattr(self.backend, "run_rounds", None)
        if command not in ("attack", "retreat"):
            # The leader's raw-string quirk (ba.py:284-285) is invisible to
            # the device quorum: the sequential path keeps it exact.
            run_rounds = None
        pipelined = None
        round_base = self._round
        t0 = time.perf_counter()
        if run_rounds is not None:
            host_work = None
            if metrics.default_sink().enabled:
                def host_work(dispatch):  # between dispatches, while the card works
                    metrics.emit({"event": "pipeline_dispatch", "dispatch": dispatch,
                                  "round_base": round_base, "n": len(self.generals),
                                  "order": command})

            with obs.span("agreement_rounds", rounds=rounds, n=len(self.generals)):
                pipelined = run_rounds(
                    self.generals, leader_idx, command_from_name(command),
                    self._round_seed(), rounds, host_work=host_work,
                )
        if pipelined is None:
            res = None
            counts = {"attack": 0, "retreat": 0, "undefined": 0}
            for _ in range(rounds):
                res = self.actual_order(command)
                counts[res.decision] += 1
            return res, counts, None
        majorities, decisions, stats = pipelined
        elapsed = time.perf_counter() - t0
        self._round += rounds
        res = self._tally(command, leader_idx, majorities)
        counts = _decision_counts(decisions)
        metrics.emit({
            # the engine's run scope closed when run_rounds returned: the
            # summary carries its id explicitly
            **({"run_id": stats["run_id"]} if stats.get("run_id") else {}),
            "event": "agreement_rounds_pipelined", "round_base": round_base,
            "rounds": rounds, "n": len(self.generals), "leader_id": self.leader_id,
            "order": command, "decision_counts": counts, "dispatches": stats["dispatches"],
            "depth": stats["depth"], "counters": stats.get("counters"),
            "elapsed_s": round(elapsed, 6),
        })
        return res, counts, stats

    def run_scenario(
        self,
        spec,
        checkpoint_every=None,
        checkpoint_path=None,
        checkpoint_keep_last=None,
        supervise=False,
        fault_plan=None,
        mesh=None,
        health_every=None,
        engine=None,
    ):
        """Run a declarative scenario campaign (``ba_tpu_torch.scenario``)
        on this cluster as one pipelined device run.

        Afterwards the roster adopts the campaign's final state: generals
        dead at the end leave it, fault flags follow the last
        ``set_faulty``, and the leader is the campaign's final elected
        leader (election is for life across the boundary).  The options
        go to the backend's ``run_scenario``: ``supervise=True`` runs the
        campaign under the supervisor (its block rides
        ``result["stats"]["supervisor"]``), ``fault_plan`` injects faults
        into it, ``health_every`` samples the engine's health.  Returns
        ``(counts, result)``, or None when the cluster is empty or the
        backend cannot run scenarios (PyBackend, SM).
        """
        if not self.generals:
            return None  # the reference would crash here (SURVEY.md Q4)
        self.tick()
        run = getattr(self.backend, "run_scenario", None)
        if run is None:
            return None
        obs.instant("scenario_repl", scenario=spec.name, rounds=spec.rounds)
        with obs.span("scenario_campaign", rounds=spec.rounds, n=len(self.generals)):
            res = run(
                self.generals, self._leader_idx(), command_from_name(spec.order),
                self._round_seed(), spec,
                checkpoint_every=checkpoint_every,
                checkpoint_path=checkpoint_path,
                checkpoint_keep_last=checkpoint_keep_last,
                supervise=supervise,
                fault_plan=fault_plan,
                mesh=mesh,
                health_every=health_every,
                engine=engine,
            )
        if res is None:
            return None
        self._round += spec.rounds
        roster = list(self.generals)
        for g, alive, faulty in zip(roster, res["alive"], res["faulty"]):
            g.faulty = faulty
            g.alive = alive
        dead = [g.id for g in roster if not g.alive]
        self.generals = [g for g in roster if g.alive]
        prev = self.leader_id
        last_leader = res["leaders"][-1]
        if 0 <= last_leader < len(roster) and roster[last_leader].alive:
            self.leader_id = roster[last_leader].id
        else:
            self.leader_id = None
        if self.leader_id != prev and self.leader_id is not None:
            _elected(self.leader_id, prev)
        self.tick()
        counts = _decision_counts(res["decisions"])
        stats = res["stats"]
        metrics.emit({
            **({"run_id": stats["run_id"]} if stats.get("run_id") else {}),
            "event": "scenario_campaign", "name": spec.name, "rounds": spec.rounds,
            "order": spec.order, "decision_counts": counts, "counters": res["counters"],
            "killed": dead, "leader_id": self.leader_id, "n": len(self.generals),
            "dispatches": stats["dispatches"], "checkpoints": stats.get("checkpoints", 0),
            **({"supervisor": stats["supervisor"]} if "supervisor" in stats else {}),
        })
        return counts, res

    def run_search(self, space=None, **kwargs):
        """An adversary hunt (``ba_tpu_torch.search``) sized to this
        cluster's padded capacity: populations of candidate campaigns
        evaluated batched, objective violations collected and, by default,
        shrunk to minimal reproducers.  The roster is not touched: the
        candidates run from the canonical all-honest state.  ``space`` /
        ``kwargs`` go to the backend's ``run_search``.  Returns the hunt's
        result, or None when the cluster is empty or the backend cannot
        search (PyBackend, signed or SM)."""
        if not self.generals:
            return None  # the reference would crash here (SURVEY.md Q4)
        run = getattr(self.backend, "run_search", None)
        if run is None:
            return None
        obs.instant("search_repl", n=len(self.generals))
        with obs.span("search_hunt", n=len(self.generals)):
            res = run(self.generals, self._round_seed(), space=space, **kwargs)
        if res is None:
            return None
        stats = res["stats"]
        metrics.emit({
            **({"run_id": stats["run_id"]} if stats.get("run_id") else {}),
            "event": "search_campaign", "objective": stats["objective"],
            "generations": stats["generations_run"], "campaigns": stats["campaigns"],
            "found": stats["found"], "minimized": stats["minimized"],
            "best_score": stats["best_score"], "n": len(self.generals),
        })
        return res

    def _tally(self, command: str, leader_idx: int, majorities) -> RoundResult:
        """REPL-level bookkeeping for one round's majorities (ba.py:383-399
        and 197-255), shared by the per-round and pipelined paths."""
        per_general = []
        n_attack = n_retreat = n_undefined = 0
        nr_faulty = 0
        for i, g in enumerate(self.generals):
            is_primary = i == leader_idx
            if is_primary:
                maj_str = command  # raw string passthrough (ba.py:284-285)
                bucket = {"attack": ATTACK, "retreat": RETREAT}.get(command, UNDEFINED)
            else:
                maj_str = COMMAND_NAMES[majorities[i]]
                bucket = majorities[i]
            if bucket == ATTACK:
                n_attack += 1
            elif bucket == RETREAT:
                n_retreat += 1
            else:
                n_undefined += 1
            if g.faulty:
                nr_faulty += 1
            per_general.append((g.id, is_primary, maj_str, g.faulty))

        total = n_attack + n_retreat + n_undefined
        needed = quorum_threshold_py(total)
        if needed <= n_retreat:  # retreat first: ties prefer retreat (Q7)
            decision = "retreat"
        elif needed <= n_attack:
            decision = "attack"
        else:
            decision = "undefined"
        return RoundResult(
            per_general=per_general,
            nr_faulty=nr_faulty,
            n_attack=n_attack,
            n_retreat=n_retreat,
            n_undefined=n_undefined,
            needed=needed,
            total=total,
            decision=decision,
        )

    def _round_seed(self) -> int:
        return (self.seed << 20) ^ self._round


def _elected(leader_id: int, prev) -> None:
    obs.instant("election", leader_id=leader_id, prev=prev)
    obs.default_registry().counter("elections_total").inc()


def _decision_counts(decisions) -> dict:
    """Per-round quorum decision codes -> the REPL's tally by name."""
    names = {ATTACK: "attack", RETREAT: "retreat"}
    counts = {"attack": 0, "retreat": 0, "undefined": 0}
    for d in decisions:
        counts[names.get(d, "undefined")] += 1
    return counts
