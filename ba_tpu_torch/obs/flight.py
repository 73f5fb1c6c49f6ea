"""The flight recorder (``ba_tpu/obs/flight.py``): the id that joins a
campaign's records, checkpoints and resumes, the scope that holds it, and
the join itself.

- **run id**: every campaign run gets one: the caller's, the active run
  scope's, the one a resume checkpoint's header carries, or one derived
  from the campaign's identity (the round count, the key data's bytes,
  the scenario's content), so a killed run's successor derives the same
  id without any handshake.  The JAX package's ``BA_TPU_RUN_ID`` variable
  is the ``run_id=`` keyword here.
- **run scope** (:func:`run_scope`): ``pipeline_sweep`` and
  ``supervised_sweep`` each open one; scopes nest (a supervisor's
  attempts keep its id), and only the outermost, the owner, emits the
  ``flight_summary`` record at the end.  While a scope is active the
  sink stamps its id on every record and the tracer on every span.
- **the join** (:class:`FlightLog`, :func:`assemble_flight`): one run's
  records out of a JSON-lines stream, its dispatch windows deduplicated
  by round (a recovery replays windows on the same grid), into one
  versioned ``{"event": "flight_summary", "v": 1}`` record.

Stdlib only: the assembler runs wherever the stream was copied to.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re

from ba_tpu_torch.utils import metrics as _metrics

# Leading alnum, then alnum / ._:- up to 64 characters: ids survive file
# names, metric labels and shell quoting.
RUN_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,63}$")

FLIGHT_SUMMARY_VERSION = 1

# The record families that carry a run_id whenever a scope is active,
# by construction (``ba_tpu/obs/flight.py``'s set; ba-lint's
# ``analysis/contracts.RUN_SCOPED_EVENTS`` is pinned equal to it): every
# campaign, hunt and SLO window runs inside a run scope, and the
# sign-ahead lane stamps its own id.
RUN_SCOPED_EVENTS = frozenset({
    "flight_span", "scenario_checkpoint", "recovery", "fault_injected",
    "health_snapshot", "flight_summary", "search_generation", "search_found",
    "search_minimized", "search_checkpoint", "sign_pool", "slo_report", "slo_alert",
    "autoscale_signal",
})


def valid_run_id(run_id) -> bool:
    return isinstance(run_id, str) and bool(RUN_ID_RE.match(run_id))


def derive_run_id(*material) -> str:
    """``run-<sha256[:16]>`` over the campaign identity material: ``bytes``
    (or a ``memoryview`` of them) hash raw, anything else its ``str()``,
    each followed by a NUL."""
    h = hashlib.sha256()
    for m in material:
        h.update(m if isinstance(m, (bytes, memoryview)) else str(m).encode())
        h.update(b"\x00")
    return "run-" + h.hexdigest()[:16]


def resolve_run_id(*material, run_id: str | None = None, inherited: str | None = None,
                   material_fn=None) -> str:
    """The run id a campaign uses, by precedence:

    1. ``run_id``, the caller's (validated: a malformed id raises);
    2. the active run scope's id (a nested campaign inherits it);
    3. ``inherited``, the id a resume checkpoint's header carries, when
       it is well formed;
    4. :func:`derive_run_id` over ``material`` and then ``material_fn()``
       (a zero-argument callable, so the key fetch and the scenario's
       hashing are paid only when this step runs).
    """
    if run_id is not None:
        if not valid_run_id(run_id):
            raise ValueError(f"run_id={run_id!r} is not a valid run id "
                             f"(want {RUN_ID_RE.pattern})")
        return run_id
    active = _metrics.active_run_id()
    if active is not None:
        return active
    if inherited is not None and valid_run_id(inherited):
        return inherited
    if material_fn is not None:
        material = material + tuple(material_fn())
    return derive_run_id(*material)


class RunScope:
    """What :func:`run_scope` yields: the effective ``run_id`` and whether
    this scope owns it (``owner``: the outermost one, which emits the
    flight summary)."""

    __slots__ = ("run_id", "owner")

    def __init__(self, run_id: str, owner: bool):
        self.run_id = run_id
        self.owner = owner


@contextlib.contextmanager
def run_scope(run_id: str):
    """Make ``run_id`` the active run for the block.  Inside an active
    scope the outer id stays and ``owner`` is False; the owner's exit
    clears the id, exception or not."""
    active = _metrics.active_run_id()
    if active is not None:
        yield RunScope(active, owner=False)
        return
    _metrics.set_run_id(run_id)
    try:
        yield RunScope(run_id, owner=True)
    finally:
        _metrics.set_run_id(None)


# -- the join ------------------------------------------------------------------


def _parse_jsonl(path: str, needle: str | None = None):
    """The file's records, lines without ``needle`` skipped before they
    are parsed (a long shared stream is read at the end of every owned
    run), torn or non-object lines skipped."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or (needle is not None and needle not in line):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn tail line from a killed writer
            if isinstance(rec, dict):
                yield rec


class FlightLog:
    """One run's records, joined.  :meth:`add` folds records in and
    :meth:`summary` builds the ``flight_summary``:

    - dispatch windows (``flight_span``) key by ``lo``: a replayed window
      replaces the first one, an OOM-degraded replay's finer grid chains,
      and ``contiguous`` says whether the windows cover every round once;
    - checkpoints key by round (the last write wins);
    - recompiles dedupe by (fn, changed axes);
    - recoveries and faults are kept in order.

    No module of this package emits ``recompile`` records or sets the
    per-shard gauges of a ``metrics_snapshot`` (``pipeline_shards``,
    ``*_bytes_per_shard``): those two branches fold streams that the JAX
    package wrote, so a summary of such a stream equals its own.  On a
    stream of this package ``recompiles`` is ``[]`` and ``per_shard``
    None."""

    def __init__(self, run_id: str | None = None):
        self.run_id = run_id
        self._windows: dict = {}
        self._checkpoints: dict = {}
        self._recoveries: list = []
        self._faults: list = []
        self._recompiles: dict = {}
        self._health: list = []
        self._events: dict = {}
        self._last_per_shard: dict = {}

    def add(self, rec: dict) -> bool:
        """Fold one record in; True when it belongs to this run (its
        ``run_id`` matches, or it has none).  Summaries are never folded."""
        event = rec.get("event")
        if event == "flight_summary":
            return False
        rid = rec.get("run_id")
        if self.run_id is not None and rid is not None and rid != self.run_id:
            return False
        if self.run_id is None and rid is not None:
            self.run_id = rid
        self._events[event] = self._events.get(event, 0) + 1
        if event == "flight_span":
            lo = rec.get("lo")
            if isinstance(lo, int):
                self._windows[lo] = {"lo": lo, "hi": rec.get("hi"),
                                     "dispatch": rec.get("dispatch"),
                                     "latency_s": rec.get("latency_s"),
                                     "lag_s": rec.get("lag_s"), "ts": rec.get("ts")}
        elif event == "scenario_checkpoint":
            rnd = rec.get("round")
            if isinstance(rnd, int):
                self._checkpoints[rnd] = {"round": rnd, "path": rec.get("path"),
                                          "bytes": rec.get("bytes"),
                                          "shard_layout": rec.get("shard_layout"),
                                          "ts": rec.get("ts")}
        elif event == "recovery":
            self._recoveries.append({k: rec.get(k) for k in (
                "fault", "action", "attempt", "from_round", "lost_rounds", "error", "ts")})
        elif event == "fault_injected":
            self._faults.append({k: rec.get(k) for k in ("plan", "kind", "phase", "round", "ts")})
        elif event == "recompile":
            changed = rec.get("changed")
            self._recompiles.setdefault(
                (rec.get("fn"), json.dumps(changed, sort_keys=True)),
                {"fn": rec.get("fn"), "changed": changed,
                 "cross_process": rec.get("cross_process"), "ts": rec.get("ts")})
        elif event == "health_snapshot":
            self._health.append(rec)
        elif event == "metrics_snapshot":
            metrics = rec.get("metrics", {})
            for g in ("pipeline_shards", "pipeline_carry_bytes_per_shard",
                      "scenario_plane_bytes_per_shard"):
                snap = metrics.get(g)
                if isinstance(snap, dict) and "value" in snap:
                    self._last_per_shard[g] = snap["value"]
        return True

    def _chain(self):
        """The windows sorted by ``lo``, whether they chain without a gap,
        and where the chain ends."""
        windows = sorted(self._windows.values(), key=lambda w: w["lo"])
        contiguous = bool(windows)
        pos = windows[0]["lo"] if windows else 0
        for w in windows:
            if w["lo"] != pos or not isinstance(w["hi"], int):
                contiguous = False
                break
            pos = w["hi"]
        return windows, contiguous, pos

    def summary(self) -> dict:
        windows, contiguous, end = self._chain()
        checkpoints = [self._checkpoints[r] for r in sorted(self._checkpoints)]
        lat = [w["latency_s"] for w in windows if isinstance(w.get("latency_s"), (int, float))]
        timeline = sorted(
            [{"kind": "dispatch_window", **w} for w in windows]
            + [{"kind": "checkpoint", **c} for c in checkpoints]
            + [{"kind": "recovery", **r} for r in self._recoveries]
            + [{"kind": "fault", "injected": f.get("kind"), "phase": f.get("phase"),
                "round": f.get("round"), "plan": f.get("plan"), "ts": f.get("ts")}
               for f in self._faults]
            + [{"kind": "recompile", **r} for r in self._recompiles.values()],
            key=lambda e: e["ts"] if isinstance(e.get("ts"), (int, float)) else 0.0,
        )
        return {
            "event": "flight_summary",
            "v": FLIGHT_SUMMARY_VERSION,
            "run_id": self.run_id,
            "rounds": [windows[0]["lo"], end] if windows else None,
            "contiguous": contiguous,
            "windows": len(windows),
            "checkpoints": checkpoints,
            "recoveries": self._recoveries,
            "faults": self._faults,
            "recompiles": list(self._recompiles.values()),
            "health_snapshots": len(self._health),
            "last_health": self._health[-1] if self._health else None,
            "shard_layout": checkpoints[-1]["shard_layout"] if checkpoints else None,
            "per_shard": self._last_per_shard or None,
            "dispatch_latency_max_s": max(lat) if lat else None,
            "events": dict(sorted(self._events.items())),
            "timeline": timeline,
        }


def assemble_flight(jsonl_path: str, run_id: str | None = None):
    """One run's ``flight_summary`` out of a JSON-lines file (None when the
    file holds nothing of it); ``run_id=None`` picks the last run id the
    file names."""
    if run_id is None:
        for rec in _parse_jsonl(jsonl_path, needle='"run_id"'):
            rid = rec.get("run_id")
            if rid is not None and rec.get("event") != "flight_summary":
                run_id = rid
    log = FlightLog(run_id)
    needle = f'"{run_id}"' if run_id is not None else None
    matched = sum(log.add(rec) for rec in _parse_jsonl(jsonl_path, needle=needle))
    return log.summary() if matched else None


def emit_flight_summary(sink=None, run_id: str | None = None):
    """Assemble the sink's own file and append the ``flight_summary``
    record to it: the scope owner's last act.  A disabled or stderr sink
    has nothing to read back, so this returns None."""
    sink = sink or _metrics.default_sink()
    target = sink.file_path()
    if not target or not os.path.exists(target):
        return None
    summary = assemble_flight(target, run_id=run_id)
    if summary is not None:
        sink.emit(summary)
    return summary
