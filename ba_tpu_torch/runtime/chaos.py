"""Host-side fault injection (``ba_tpu/runtime/chaos.py``): deterministic
chaos for the serving tier and the supervised engine.

A :class:`FaultPlan` is plain data (a JSON round trip, validated when it
is read) naming faults at chosen rounds; a :class:`ChaosInjector` fires
them from an engine's execution seam (``coalesced_sweep(exec_seam=)``,
``pipeline_sweep(exec_seam=)`` under ``runtime/supervisor.supervised_sweep``):

- ``transient`` / ``fatal`` / ``oom`` raise a marked exception
  (:class:`InjectedTransient`, :class:`InjectedFatal`,
  :class:`InjectedOOM`) before the wrapped operation runs, so an
  injected failure never consumes the carry and an in-place retry is
  bit-exact;
- ``stall`` sleeps ``seconds`` inside the watched region;
- ``kill`` sends this process ``SIGKILL``;
- ``corrupt`` damages a just-written checkpoint (``flip`` or
  ``truncate``);
- ``slow_client`` / ``abandon`` / ``deadline_storm`` are faults of the
  callers, fired at the ``client`` phase by a serving load harness
  through :meth:`ChaosInjector.client_faults`, keyed by request ordinal.

Engine faults key on the round, not the dispatch index.  The plans in
``examples/faults/`` load unchanged; ``python -m
ba_tpu_torch.runtime.chaos plan.json ...`` checks plans (exit 1 at the
first bad one, 2 without arguments).  Stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time

from ba_tpu_torch import obs
from ba_tpu_torch.utils import metrics as _metrics

# Client-tier kinds: faults of the CALLERS, not the engine —
# they fire at the "client" phase, consumed by a serving-load harness
# (chip_smoke.py's serving phases, the serving tests) shaping synthetic
# clients against the agreement service (runtime/serve.py), keyed by
# REQUEST ORDINAL instead of campaign round:
#
# - ``slow_client`` — the client sleeps ``seconds`` before submitting
#   (a stalled upstream: requests arrive late and bunch up);
# - ``abandon`` — the client submits and never reads its ticket (the
#   service must complete/expire it without anyone waiting);
# - ``deadline_storm`` — the client fleet switches to near-zero
#   deadline budgets from this ordinal on (every coalesced batch then
#   races admission-time expiry — the overload-survival drill).
CLIENT_FAULT_KINDS = ("slow_client", "abandon", "deadline_storm")
FAULT_KINDS = (
    "transient", "fatal", "oom", "stall", "kill", "corrupt"
) + CLIENT_FAULT_KINDS
# corrupt fires from the checkpoint hook, client kinds from the serving
# load harness, everything else from the execution seam's
# dispatch/retire phases.
FAULT_PHASES = ("dispatch", "retire", "checkpoint", "client")


class FaultPlanError(ValueError):
    """A malformed fault plan (bad kind/phase/fields) — eagerly raised
    at ``from_dict`` time, never mid-campaign."""


class InjectedFault(RuntimeError):
    """Base of every chaos-raised error; ``ba_tpu_fault`` is the
    classification marker ``supervisor.classify_fault`` reads (duck
    typing, so the supervisor never imports this module)."""

    ba_tpu_fault = "fatal"


class InjectedTransient(InjectedFault):
    ba_tpu_fault = "transient"


class InjectedFatal(InjectedFault):
    ba_tpu_fault = "fatal"


class InjectedOOM(InjectedFault):
    """Its message carries an allocator's out-of-memory phrasing, so the
    string-marker classification path is exercised too."""

    ba_tpu_fault = "oom"


_RAISES = {
    "transient": InjectedTransient,
    "fatal": InjectedFatal,
    "oom": InjectedOOM,
}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.  ``round`` is the campaign round it keys on —
    or, for client-tier kinds (``phase == "client"``), the REQUEST
    ORDINAL in the load harness's submission sequence.  ``times`` is
    how often it fires (-1 = unlimited — the poison-window tests);
    ``seconds`` is the stall/slow-client length; ``mode`` the
    corruption style."""

    round: int
    kind: str
    phase: str = "dispatch"
    times: int = 1
    seconds: float = 0.0
    mode: str = "flip"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    name: str
    faults: tuple


def from_dict(doc: dict) -> FaultPlan:
    """Parse + eagerly validate a fault-plan document."""
    if not isinstance(doc, dict):
        raise FaultPlanError(f"fault plan must be an object, got {type(doc)}")
    unknown = set(doc) - {"name", "faults"}
    if unknown:
        raise FaultPlanError(f"unknown fault plan key(s) {sorted(unknown)}")
    name = doc.get("name")
    if not isinstance(name, str) or not name:
        raise FaultPlanError(f"fault plan needs a non-empty name, got {name!r}")
    raw = doc.get("faults")
    if not isinstance(raw, list):
        raise FaultPlanError(f"faults must be a list, got {type(raw)}")
    faults = []
    for i, f in enumerate(raw):
        if not isinstance(f, dict):
            raise FaultPlanError(f"faults[{i}] must be an object")
        unknown = set(f) - {"round", "kind", "phase", "times", "seconds",
                            "mode"}
        if unknown:
            raise FaultPlanError(
                f"faults[{i}]: unknown key(s) {sorted(unknown)}"
            )
        kind = f.get("kind")
        if kind not in FAULT_KINDS:
            raise FaultPlanError(
                f"faults[{i}]: kind {kind!r} not in {FAULT_KINDS}"
            )
        rnd = f.get("round")
        if not isinstance(rnd, int) or isinstance(rnd, bool) or rnd < 0:
            raise FaultPlanError(f"faults[{i}]: bad round {rnd!r}")
        phase = f.get("phase", _default_phase(kind))
        if phase not in FAULT_PHASES:
            raise FaultPlanError(
                f"faults[{i}]: phase {phase!r} not in {FAULT_PHASES}"
            )
        if phase != _default_phase(kind) and not (
            kind not in ("corrupt",) + CLIENT_FAULT_KINDS
            and phase in ("dispatch", "retire")
        ):
            raise FaultPlanError(
                f"faults[{i}]: kind {kind!r} cannot fire at phase {phase!r} "
                f"(corrupt fires at 'checkpoint', client kinds "
                f"{CLIENT_FAULT_KINDS} at 'client', everything else at "
                f"'dispatch'/'retire')"
            )
        times = f.get("times", 1)
        if not isinstance(times, int) or isinstance(times, bool) or (
            times < 1 and times != -1
        ):
            raise FaultPlanError(
                f"faults[{i}]: times must be >= 1 or -1 (unlimited), "
                f"got {times!r}"
            )
        seconds = f.get("seconds", 0.0)
        if not isinstance(seconds, (int, float)) or isinstance(
            seconds, bool
        ) or seconds < 0:
            raise FaultPlanError(f"faults[{i}]: bad seconds {seconds!r}")
        if (kind in ("stall", "slow_client")) != (seconds > 0):
            raise FaultPlanError(
                f"faults[{i}]: seconds is the stall/delay length — "
                f"required > 0 for kinds 'stall'/'slow_client', "
                f"meaningless otherwise"
            )
        mode = f.get("mode", "flip")
        if mode not in ("flip", "truncate"):
            raise FaultPlanError(
                f"faults[{i}]: corrupt mode {mode!r} not in "
                f"('flip', 'truncate')"
            )
        faults.append(
            Fault(round=rnd, kind=kind, phase=phase, times=times,
                  seconds=float(seconds), mode=mode)
        )
    return FaultPlan(name=name, faults=tuple(faults))


def _default_phase(kind) -> str:
    if kind == "corrupt":
        return "checkpoint"
    if kind in CLIENT_FAULT_KINDS:
        return "client"
    return "dispatch"


def to_dict(plan: FaultPlan) -> dict:
    """The exact inverse of :func:`from_dict` (round-trip pinned by the
    CLI and tests): defaulted fields are omitted, so a loaded-and-saved
    plan is byte-stable."""
    faults = []
    for f in plan.faults:
        d = {"round": f.round, "kind": f.kind}
        if f.phase != _default_phase(f.kind):
            d["phase"] = f.phase
        if f.times != 1:
            d["times"] = f.times
        if f.kind in ("stall", "slow_client"):
            d["seconds"] = f.seconds
        if f.kind == "corrupt" and f.mode != "flip":
            d["mode"] = f.mode
        faults.append(d)
    return {"name": plan.name, "faults": faults}


def load(path: str) -> FaultPlan:
    with open(path) as fh:
        return from_dict(json.load(fh))


def save(path: str, plan: FaultPlan) -> None:
    with open(path, "w") as fh:
        json.dump(to_dict(plan), fh, indent=2)
        fh.write("\n")


def corrupt_file(path: str, mode: str = "flip") -> None:
    """Deterministically damage ``path``: ``flip`` inverts 64 bytes at
    the middle of the file (data-region damage the content digest
    catches even when the zip directory survives); ``truncate`` keeps
    the first half (torn-file damage the zip reader catches)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(max(1, size // 2))
        return
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        chunk = fh.read(min(64, max(1, size - size // 2)))
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in chunk))


class ChaosInjector:
    """Fires a plan's faults from the engine's execution seam.

    One injector instance spans one supervised campaign INCLUDING its
    recoveries: consumed ``times`` stay consumed across engine restarts,
    which is what makes "inject one fatal fault, recover, complete"
    deterministic.  ``fired`` records every injection (kind, round,
    phase) for tests and the supervisor's stats block.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining = [f.times for f in plan.faults]
        self.fired = []

    def _consume(self, i, fault, lo, hi):
        if self._remaining[i] > 0:
            self._remaining[i] -= 1
        self.fired.append(
            {"kind": fault.kind, "phase": fault.phase, "round": fault.round,
             "window": [lo, hi]}
        )
        obs.instant(
            "fault_injected", kind=fault.kind, phase=fault.phase,
            round=fault.round, lo=lo, hi=hi,
        )
        obs.default_registry().counter("chaos_injected_total").inc()
        _metrics.emit(
            {
                "event": "fault_injected",
                "v": _metrics.SCHEMA_VERSION,
                "plan": self.plan.name,
                "kind": fault.kind,
                "phase": fault.phase,
                "round": fault.round,
            }
        )

    def fire(self, call, phase, lo, hi):
        """The seam body: inject any due faults for rounds ``[lo, hi)``
        at ``phase``, then run the real operation.

        Raising kinds fire BEFORE ``call`` so the donated carry is never
        consumed by an injected failure — the supervisor's in-place
        retry of the same zero-arg ``call`` is then bit-exact.
        """
        for i, f in enumerate(self.plan.faults):
            if f.phase != phase or not lo <= f.round < hi:
                continue
            if self._remaining[i] == 0:
                continue
            self._consume(i, f, lo, hi)
            if f.kind == "stall":
                time.sleep(f.seconds)
                continue
            if f.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise _RAISES[f.kind](
                f"injected {f.kind} fault at rounds [{lo}, {hi}) "
                f"(plan {self.plan.name!r}"
                + (", RESOURCE_EXHAUSTED: Out of memory)"
                   if f.kind == "oom" else ")")
            )
        return call()

    def client_faults(self, ordinal: int):
        """Client-tier faults due at request ``ordinal``.

        Consumed by a serving load harness (chip_smoke.py, the serving
        tests) shaping synthetic clients — the service
        itself never reads these: a real client's slowness or
        abandonment happens outside the process.  Returns the fired
        :class:`Fault` list (``times`` consumed, ``fault_injected``
        records emitted with ``phase: "client"``); the caller applies
        the semantics — sleep ``seconds`` for ``slow_client``, drop the
        ticket for ``abandon``, switch to near-zero deadlines from here
        on for ``deadline_storm``.

        Matching is by EXACT ordinal, so in a harness that draws each
        ordinal once, ``times > 1`` never fires more than once — plan
        one fault entry per ordinal to inject repeatedly (``times``
        matters only when a harness re-queries an ordinal, e.g. one
        submission retried after a rejection).
        """
        fired = []
        for i, f in enumerate(self.plan.faults):
            if f.phase != "client" or f.round != ordinal:
                continue
            if self._remaining[i] == 0:
                continue
            self._consume(i, f, ordinal, ordinal + 1)
            fired.append(f)
        return fired

    def after_checkpoint(self, round_cursor, path):
        """The checkpoint hook: corrupt a just-written checkpoint whose
        round window reached the fault's round."""
        for i, f in enumerate(self.plan.faults):
            if f.kind != "corrupt" or self._remaining[i] == 0:
                continue
            if round_cursor < f.round:
                continue
            self._consume(i, f, round_cursor, round_cursor)
            corrupt_file(path, f.mode)


def _check_plan(path: str) -> str:
    plan = load(path)
    doc = to_dict(plan)
    if to_dict(from_dict(json.loads(json.dumps(doc)))) != doc:
        raise FaultPlanError("to_dict/from_dict round-trip drifted")
    kinds = {}
    for f in plan.faults:
        kinds[f.kind] = kinds.get(f.kind, 0) + 1
    summary = ", ".join(f"{k}x{v}" for k, v in sorted(kinds.items()))
    return (
        f"{path}: OK — {plan.name!r}, {len(plan.faults)} fault(s)"
        + (f" ({summary})" if summary else "")
    )


def main(argv) -> int:
    if not argv:
        print(
            "usage: python -m ba_tpu_torch.runtime.chaos <plan.json> ...",
            file=sys.stderr,
        )
        return 2
    for path in argv:
        try:
            print(_check_plan(path))
        except (OSError, ValueError) as e:  # FaultPlanError is a ValueError
            print(f"{path}: FAIL — {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
