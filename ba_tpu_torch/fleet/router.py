"""The fleet router (the port's copy of ``ba_tpu/fleet/router.py``):
consistent-hash request routing over ready replicas, overload-aware hops,
rerouting off a dead or draining replica, and the ``autoscale_signal``
control loop.

**Ring.**  A consistent-hash ring of ``vnodes`` sha256 points a member
(the reference's points, so one cohort has one home in both packages),
a request keyed on its whole cohort label
(``serve.cohort_label(cohort_key(req))``: scenario-ness, rounds, padded
capacity, engine, ``m``, ``signed``): every request of a cohort lands on
one replica and coalesces there, while distinct cohorts spread.  A
membership change moves only the cohorts of the member that left or
came.

**Overload is a hop.**  An :class:`~ba_tpu_torch.runtime.serve.Overloaded`
admission retries the next ring member (at most ``max_hops``); when every
hop rejects, the router raises with the origin replica's (the cohort's
home's) ``retry_after_s``, the signal the client should back off against.

**No hung client.**  A replica that dies or drains fails its queued
tickets with :class:`~ba_tpu_torch.runtime.serve.ServeError`;
:class:`RoutedTicket` catches exactly that (deadline and request failures
are outcomes and re-raise) and re-submits on the next surviving member,
at most ``max_hops`` times, as the replica fails it (the reference waits
for the caller's next ``result``; class docstring).

**Autoscale.**  :meth:`FleetRouter.apply_autoscale` takes an
``autoscale_signal`` record (the SLO engine's, or :meth:`control_step`'s
own through ``obs.slo.recommend_replicas`` off the ``health_slo_burn``
gauge) and starts or drains replicas to the recommendation; a drain goes
through ``migrate.drain``, so scale-in never abandons a campaign.

Importing this module loads no torch.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time

from ba_tpu_torch import obs
from ba_tpu_torch.runtime.serve import (
    DeadlineExceeded,
    Overloaded,
    RequestFailed,
    ServeError,
    cohort_key,
    cohort_label,
)
from ba_tpu_torch.utils import metrics as _metrics


def _point(member: str, vnode: int) -> int:
    digest = hashlib.sha256(f"{member}#{vnode}".encode()).hexdigest()
    return int(digest[:16], 16)


def _key_point(key: str) -> int:
    return int(hashlib.sha256(key.encode()).hexdigest()[:16], 16)


class HashRing:
    """Deterministic consistent-hash ring: ``vnodes`` sha256 points per
    member; ``prefer(key)`` walks clockwise from the key's point and
    returns every member once, in preference order (hash home first —
    the same order in every process that knows the member list)."""

    def __init__(self, members=(), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes={vnodes} must be >= 1")
        self.vnodes = vnodes
        self._points: list = []
        self._owners: list = []
        self._members: tuple = ()
        self.rebuild(members)

    def rebuild(self, members) -> None:
        members = tuple(sorted(set(members)))
        pairs = sorted(
            (_point(m, v), m)
            for m in members
            for v in range(self.vnodes)
        )
        self._points = [p for p, _ in pairs]
        self._owners = [m for _, m in pairs]
        self._members = members

    @property
    def members(self) -> tuple:
        return self._members

    def prefer(self, key: str) -> list:
        """Preference order for ``key``: unique members from its ring
        point clockwise.  Empty ring → empty list."""
        if not self._points:
            return []
        start = bisect.bisect_right(self._points, _key_point(key))
        order: list = []
        seen = set()
        n = len(self._owners)
        for i in range(n):
            owner = self._owners[(start + i) % n]
            if owner not in seen:
                seen.add(owner)
                order.append(owner)
        return order


def _rehomable(error) -> bool:
    """A replica that stopped or drained before dispatching: a routing
    event.  Deadline, request and overload failures are outcomes."""
    return isinstance(error, ServeError) and not isinstance(
        error, (DeadlineExceeded, RequestFailed, Overloaded))


class RoutedTicket:
    """The client's handle on a ROUTED request: wraps the live
    replica's :class:`~ba_tpu_torch.runtime.serve.Ticket` and, when that
    replica dies or drains before dispatch (``ServeError``), re-submits
    on the next surviving ring member — transparently, inside the
    caller's ``result`` budget, bounded by the router's ``max_hops``.
    Deadline/request failures and timeouts re-raise untouched: those
    are outcomes, not routing events.  Single-caller contract (like
    ``Ticket``): ``result`` is not re-entrant.

    The port re-homes when the replica fails the ticket (the ticket's
    fail hook), not when the caller next waits on it, as the reference
    does: a drained replica's backlog then reaches the survivor at once
    and coalesces there, where re-homing at each caller's wait would
    trickle it in one ticket a client.  A ticket that failed before its
    hook was set is re-homed in ``result``; a re-homing that finds no
    survivor raises from ``result``."""

    def __init__(self, router, request, deadline_s, replica_name,
                 ticket, admit_hops: int):
        self._router = router
        self.request = request
        self.deadline_s = deadline_s
        self.replica = replica_name
        self.ticket = ticket
        self.admit_hops = admit_hops
        self.reroutes = 0
        self.tried = [replica_name]
        self._lock = threading.Lock()  # the ticket swap: fail hook vs result
        self._rehome_error = None
        self._watch(ticket)

    def _watch(self, ticket) -> None:
        ticket._on_fail = self._on_failed

    def _on_failed(self, ticket, error) -> None:
        if not _rehomable(error):
            return
        with self._lock:
            if ticket is not self.ticket or self._rehome_error is not None:
                return
            try:
                self._router._rehop(self, error)
            except ServeError as e:  # no survivor, or every hop shed
                self._rehome_error = e

    @property
    def id(self):
        return self.ticket.id

    def done(self) -> bool:
        return self.ticket.done()

    def result(self, timeout: float | None = None):
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        while True:
            remaining = (
                None
                if deadline is None
                else max(0.0, deadline - time.perf_counter())
            )
            with self._lock:
                ticket, failed = self.ticket, self._rehome_error
            if failed is not None:
                raise failed
            try:
                return ticket.result(remaining)
            except (DeadlineExceeded, RequestFailed):
                raise
            except Overloaded:
                raise
            except ServeError as dead:
                # The replica stopped before dispatching us (death or
                # drain) — re-home on the next surviving member, unless
                # the fail hook already did.
                with self._lock:
                    if ticket is self.ticket and self._rehome_error is None:
                        self._router._rehop(self, dead)


class FleetRouter:
    """Routes requests over a :class:`~ba_tpu_torch.fleet.replica.
    ReplicaManager`'s ready set (module docstring for the design)."""

    def __init__(self, manager):
        self.manager = manager
        self.config = manager.config
        self.run_id = manager.run_id
        self._ring = HashRing(vnodes=self.config.vnodes)
        self._lock = threading.Lock()
        self._routes = 0
        self._reroutes = 0

    # -- ring membership -----------------------------------------------------

    def _sync_ring(self) -> list:
        ready = {r.name: r for r in self.manager.ready()}
        with self._lock:
            if tuple(sorted(ready)) != self._ring.members:
                self._ring.rebuild(ready)
        return ready

    def _emit_route(self, ticket, cohort: str, replica: str, hops: int,
                    rerouted: bool, **fields) -> None:
        rec = {
            "event": "router_route",
            "v": _metrics.SCHEMA_VERSION,
            "request_id": ticket.id if ticket is not None else None,
            "cohort": cohort,
            "replica": replica,
            "hops": hops,
            "rerouted": rerouted,
            "run_id": self.run_id,
            **fields,
        }
        if ticket is not None:
            tctx = ticket._trace
            rec["trace_id"], rec["span_id"] = tctx[0], tctx[1]
            rec["traceparent"] = _metrics.format_traceparent(
                tctx[0], tctx[1]
            )
        _metrics.emit(rec)

    # -- routing -------------------------------------------------------------

    def submit(self, request, deadline_s=...) -> RoutedTicket:
        """Admit on the cohort's hash home, hopping the ring on
        overload (bounded).  On total rejection, re-raises with the
        ORIGIN replica's ``retry_after_s`` — never a recomputed cold
        default (module docstring)."""
        ready = self._sync_ring()
        if not ready:
            raise ServeError("fleet has no ready replica")
        label = cohort_label(cohort_key(request))
        order = self._ring.prefer(label)[: self.config.max_hops]
        origin: Overloaded | None = None
        hops = 0
        for name in order:
            rep = ready.get(name)
            if rep is None or not rep.ready():
                continue
            hops += 1
            try:
                ticket = rep.submit(request, deadline_s=deadline_s)
            except Overloaded as e:
                if origin is None:
                    origin = e
                continue
            except ServeError:
                # Closed between the ready check and the submit (the
                # drain/death race) — not a member anymore, keep
                # walking the ring.
                continue
            with self._lock:
                self._routes += 1
            self._emit_route(ticket, label, name, hops, False)
            return RoutedTicket(
                self, request, deadline_s, name, ticket, hops
            )
        if origin is None:
            raise ServeError(
                "fleet has no ready replica for cohort " + label
            )
        obs.instant(
            "router_reject", cohort=label, hops=hops,
            retry_after_s=origin.retry_after_s,
        )
        # Every hop shed: the ORIGIN's hint is the real backpressure
        # signal (its queue depth x its observed batch rate) — hop
        # rejections must not launder it into a colder, smaller value.
        raise Overloaded(
            f"fleet overloaded after {hops} hop(s): {origin}",
            retry_after_s=origin.retry_after_s,
            tier=origin.tier,
            reason=origin.reason,
        )

    def _rehop(self, routed: RoutedTicket, dead: ServeError) -> None:
        """Re-home a routed ticket whose replica stopped before
        dispatch (called from :meth:`RoutedTicket.result`)."""
        if routed.reroutes >= self.config.max_hops:
            raise ServeError(
                f"request {routed.id} exhausted {routed.reroutes} "
                f"reroute(s): {dead}"
            ) from dead
        ready = self._sync_ring()
        label = cohort_label(cohort_key(routed.request))
        overload: Overloaded | None = None
        for name in self._ring.prefer(label):
            if name in routed.tried:
                continue
            rep = ready.get(name)
            if rep is None or not rep.ready():
                continue
            routed.tried.append(name)
            try:
                ticket = rep.submit(
                    routed.request, deadline_s=routed.deadline_s
                )
            except Overloaded as e:
                if overload is None:
                    overload = e
                continue
            except ServeError:
                continue  # same drain/death race as in submit()
            routed.reroutes += 1
            routed.replica = name
            routed.ticket = ticket
            routed._watch(ticket)
            with self._lock:
                self._reroutes += 1
            self._emit_route(
                ticket, label, name, routed.reroutes, True,
                from_replica=routed.tried[-2],
            )
            return
        if overload is not None:
            raise overload
        raise ServeError(
            f"request {routed.id}: no surviving replica to re-home "
            f"onto ({dead})"
        ) from dead

    # -- autoscale -----------------------------------------------------------

    def apply_autoscale(self, signal: dict) -> dict:
        """Consume one ``autoscale_signal`` record (the SLO engine's
        contract): start replicas up to the recommendation, or drain
        surplus ones (through ``migrate.drain`` — scale-in migrates,
        never abandons).  Returns ``{"started": [...], "drained":
        [...]}``."""
        recommended = int(signal["recommended"])
        recommended = max(1, min(recommended, self.config.max_replicas))
        ready = self.manager.ready()
        started, drained = [], []
        while len(ready) < recommended:
            rep = self.manager.start_replica()
            started.append(rep.name)
            ready = self.manager.ready()
        while len(ready) > max(1, recommended):
            victim = ready[-1]
            self.manager.drain(victim.name)
            drained.append(victim.name)
            ready = self.manager.ready()
        if started or drained:
            obs.instant(
                "fleet_autoscale", recommended=recommended,
                started=len(started), drained=len(drained),
            )
        return {"started": started, "drained": drained}

    def control_step(self) -> dict:
        """One control-loop tick: read fleet pressure (max per-replica
        queue occupancy, the process ``health_slo_burn`` gauge), run it
        through ``obs.slo.recommend_replicas``, EMIT the resulting
        ``autoscale_signal`` record and apply it."""
        ready = self.manager.ready()
        queue_frac = max(
            (r.health()["queue_frac"] for r in ready), default=0.0
        )
        burn = obs.default_registry().gauge("health_slo_burn").value
        recommended, reason = obs.slo.recommend_replicas(
            queue_frac,
            burn,
            replicas=len(ready),
            max_replicas=self.config.max_replicas,
        )
        rec = {
            "event": "autoscale_signal",
            "v": _metrics.SCHEMA_VERSION,
            "run_id": self.run_id,
            "recommended": recommended,
            "replicas": len(ready),
            "burn": round(float(burn), 6),
            "queue_frac": round(float(queue_frac), 6),
            "reason": reason,
            "source": "fleet_router",
        }
        _metrics.emit(rec)
        action = self.apply_autoscale(rec)
        return {**rec, **action}

    def stats(self) -> dict:
        with self._lock:
            routes, reroutes = self._routes, self._reroutes
        return {
            "replicas": [r.health() for r in self.manager.all()],
            "ready": len(self.manager.ready()),
            "routes": routes,
            "reroutes": reroutes,
            "members": list(self._ring.members),
        }
