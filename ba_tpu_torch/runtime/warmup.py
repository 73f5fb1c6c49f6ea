"""Warmup of the serving tier (``ba_tpu/runtime/warmup.py``): make the
cohort buckets' dispatches warm before traffic arrives.

- **What** (:func:`service_plan`): the cross-run compile ledger's rows
  first (:func:`ledger_replay_set`: the signatures an earlier process
  dispatched, ``obs/instrument.py``, when the service configures a
  ledger), then the cohort-key bucket lattice (:func:`bucket_lattice`).
  The service pads rosters to power-of-two capacities and cohorts to
  power-of-two batch buckets, and every cohort dispatches in
  ``rounds_per_dispatch`` windows, so the reachable signatures are
  finite.
- **How**: each signature goes through ``GraphCache.ensure``
  (``obs/graphcache.py``): a CUDA graph of one K1 slot-mode dispatch for
  ``engine="cuda"`` cohorts, the kernel libraries built and one eager
  dispatch for the others.
- **When**: on a background thread (:class:`WarmupRunner`), started by
  ``AgreementService.open()``; admission and dispatch never wait for it.
  Before each signature it polls its ``gate()`` (the service passes its
  shed-tier view) and pauses while the gate reads pressure, so warmup
  never sheds live traffic.  An unwarmed cohort still serves, eagerly,
  and is counted (``serve_warmup_miss_total``).

Every signature emits one ``warmup`` record (phases ``start`` /
``signature`` / ``done``) with a per-pass run id derived from the plan,
and the ``serve_warmup_*`` instruments track progress (the REPL's
``serve stat`` prints them).  The engine tokens are the port's:
``torch``, ``cuda`` and ``auto`` (the reference's ``xla``, ``pallas``
and ``auto``).  The lattice imports no torch.
"""

from __future__ import annotations

import itertools
import json
import threading
import time

from ba_tpu_torch import obs
from ba_tpu_torch.utils import metrics as _metrics

# The fns a warmup plan may name, as the reference spells them.  Only the
# serving cohort's megastep has a warm entry in the port; a plan naming
# another one costs one counted error, never a crash.
WARM_FNS = (
    "coalesced_megastep",
    "pipeline_megastep",
    "scenario_megastep",
    "signed_megastep",
)


def builder_for(fn: str, device=None):
    """The ``axes -> entry`` builder for ``fn`` on ``device``."""
    if fn not in WARM_FNS:
        raise ValueError(f"no warm builder for fn {fn!r} (know {WARM_FNS})")

    def build(axes: dict):
        from ba_tpu_torch.obs import graphcache

        return graphcache.build_entry(fn, axes, device)

    return build


def _axes_key(fn: str, axes: dict) -> str:
    return fn + ":" + json.dumps(axes, sort_keys=True, default=str)


def bucket_lattice(
    max_batch: int,
    rounds_per_dispatch: int,
    *,
    capacities=(4,),
    rounds: int | None = None,
    m: int = 1,
    scenarios=(False,),
    engines=("torch",),
    signeds=(False,),
    ms=None,
) -> list:
    """The serving dispatcher's reachable cohort signatures: ``(fn,
    axes)`` pairs over every power-of-two batch bucket up to the bucketed
    ``max_batch``, each capacity, each dispatch window (``rounds_per_dispatch``,
    and with a ``rounds`` hint the clipped first window and the ragged
    remainder), each m and each engine.  Signed cohorts run only on the
    torch engine and carry no scenario planes, and K1 (``"cuda"``) runs
    only m = 1: the lattice holds the reachable combinations, not the
    cross product."""
    if max_batch < 1:
        raise ValueError(f"max_batch={max_batch} must be >= 1")
    if rounds_per_dispatch < 1:
        raise ValueError(f"rounds_per_dispatch={rounds_per_dispatch} must be >= 1")
    buckets = [1]
    while buckets[-1] < max_batch:
        buckets.append(buckets[-1] * 2)
    windows = {rounds_per_dispatch}
    if rounds is not None:
        if rounds < 1:
            raise ValueError(f"rounds={rounds} must be >= 1")
        windows.add(min(rounds, rounds_per_dispatch))
        if rounds % rounds_per_dispatch:
            windows.add(rounds % rounds_per_dispatch)
    m_values = []
    for mv in (ms if ms is not None else (m,)):
        if not isinstance(mv, int) or isinstance(mv, bool) or mv < 1:
            raise ValueError(f"m value {mv!r} must be an int >= 1")
        if mv not in m_values:
            m_values.append(mv)
    for cap in capacities:
        if cap < 1:
            raise ValueError(f"capacity {cap} must be >= 1")
    plan = []
    for signed in signeds:
        combos = itertools.product(
            engines if not signed else ("torch",),
            scenarios if not signed else (False,),
            capacities, m_values, buckets, sorted(windows),
        )
        for engine, scenario, cap, mv, batch, window in combos:
            if engine == "cuda" and mv != 1:
                continue
            plan.append(("coalesced_megastep", {
                "batch": batch, "capacity": cap, "rounds": window, "m": mv,
                "max_liars": None, "unroll": 1, "scenario": bool(scenario),
                "signed": bool(signed), "collapsed": False, "engine": engine,
            }))
    return plan


def ledger_replay_set(fns=WARM_FNS) -> list:
    """Warmable ``(fn, axes)`` pairs from the cross-run compile ledger:
    rows of ``fns`` whose env axes match this process's toolchain (a row
    of another torch, CUDA, nvcc or package cannot be reproduced here),
    with the env axes and the ``run_id`` rider taken back off.  Rows of
    other engines (the reference's ``xla``, ``pallas``, ``interpret``) and
    sharded rows (``data`` > 1) are skipped.  Empty without a ledger."""
    from ba_tpu_torch.obs import instrument

    env = instrument.ledger_env_axes()
    out = []
    for fn, sigs in instrument.ledger_signatures().items():
        if fn not in fns:
            continue
        for sig in sigs:
            core = {k: v for k, v in sig.items() if k != "run_id"}
            if any(core.get(k) != v for k, v in env.items()):
                continue
            axes = {k: v for k, v in core.items() if k not in env}
            if axes.get("engine") not in ("torch", "cuda") or axes.get("data", 1) != 1:
                continue
            out.append((fn, axes))
    return out


def plan_engines(config, device=None) -> tuple:
    """The engine values the service's dispatch loop can produce: the
    torch engine always (every m, signed cohorts), and ``"cuda"`` when the
    config asks for it (``"cuda"``, or ``"auto"`` on a CUDA device) and K1
    can run there."""
    import torch

    from ba_tpu_torch.core.state import resolve_device
    from ba_tpu_torch.parallel.pipeline import resolve_engine

    requested = getattr(config, "engine", "auto") or "auto"
    if requested == "torch":
        return ("torch",)
    dev = resolve_device(device if device is not None else getattr(config, "device", None))
    try:
        resolved = resolve_engine(None if requested == "auto" else requested,
                                  torch.device(dev), getattr(config, "m", 1))
    except ValueError:
        return ("torch",)
    return ("torch",) if resolved == "torch" else ("torch", resolved)


def service_plan(config, device=None) -> list:
    """The service's warmup plan, deduped in this order: the ledger's
    serving-cohort rows of the engines the service can dispatch (real
    traffic's signatures first), then the lattice over its config (both
    scenario-nesses unless ``warm_scenarios`` is off, the signed axis
    with ``warm_signed``, the config's m and ``warm_ms``)."""
    engines = plan_engines(config, device)
    plan = [(fn, axes) for fn, axes in ledger_replay_set(("coalesced_megastep",))
            if axes["engine"] in engines]
    plan += bucket_lattice(
        config.max_batch,
        config.rounds_per_dispatch,
        capacities=config.warm_capacities,
        rounds=config.warm_rounds,
        m=config.m,
        scenarios=(False, True) if config.warm_scenarios else (False,),
        engines=engines,
        signeds=(False, True) if config.warm_signed else (False,),
        ms=(config.m,) + tuple(config.warm_ms or ()),
    )
    seen: set = set()
    deduped = []
    for fn, axes in plan:
        key = _axes_key(fn, axes)
        if key not in seen:
            seen.add(key)
            deduped.append((fn, axes))
    return deduped


def sign_cache_primer(config, device=None):
    """A thunk that stages the service's expected signed rounds through a
    one-slot ``SignAheadLane`` under sign seed 0 on ``device``, filling
    the process-default signature-table cache with the entries every
    signed cohort (``coalesced_sweep(signed=True)``) looks up.  None when
    the config warms no signed cohort."""
    if not config.warm_signed:
        return None
    rounds = config.warm_rounds or config.rounds_per_dispatch

    def prime() -> int:
        from ba_tpu_torch.crypto import pool as pool_mod

        if pool_mod.default_cache() is None:
            return 0
        from ba_tpu_torch.parallel.signing import SignAheadLane

        SignAheadLane(1, seed=0, device=device).stage(0, rounds)
        return rounds

    return prime


def health_gate(max_occupancy: float | None = None, registry=None):
    """A warmup gate off the live health view: True while the pipelined
    loops' depth occupancy reads idle (None) or below ``max_occupancy``
    (default 1.0)."""
    limit = 1.0 if max_occupancy is None else max_occupancy
    sampler = obs.health.HealthSampler(registry)
    sampler.prime()

    def gate() -> bool:
        occ = sampler.sample().get("depth_occupancy")
        return occ is None or occ < limit

    return gate


class WarmupRunner:
    """The background warmup thread: ``cache.ensure`` every ``(fn, axes)``
    of ``plan``, gated, counted.

    - ``gate()`` (optional) is polled before each signature; False pauses
      (``pause_s`` between polls) until it reads True or the runner stops.
    - :meth:`wait` is the warm barrier: every planned signature attempted.
    - A signature that fails is counted and emitted, never raised.
    - ``prime`` (optional) runs first on the runner's thread (the
      signature-table cache, :func:`sign_cache_primer`), under the same
      rule.
    """

    def __init__(self, cache, plan, *, gate=None, registry=None, run_id: str | None = None,
                 pause_s: float = 0.02, prime=None, device=None):
        self._cache = cache
        self._plan = list(plan)
        self._gate = gate
        self._pause_s = pause_s
        self._prime = prime
        self._device = device
        self._reg = registry if registry is not None else obs.default_registry()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        self.warmed = 0
        self.errors = 0
        self.captured = 0
        self.eager = 0
        self.wall_s = None
        self.run_id = run_id or obs.flight.derive_run_id(
            "warmup", *[_axes_key(fn, axes) for fn, axes in self._plan])
        self._reg.gauge("serve_warmup_signatures").set(len(self._plan))
        self._reg.gauge("serve_warmup_pending").set(len(self._plan))
        self._warmed_c = self._reg.counter("serve_warmup_warmed_total")
        self._errors_c = self._reg.counter("serve_warmup_errors_total")

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="ba-torch-warmup",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Ask the runner to wind down after the signature in hand."""
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def wait(self, timeout: float | None = None) -> bool:
        """The warm barrier: True once every planned signature was
        attempted (False on timeout)."""
        return self._done.wait(timeout)

    def done(self) -> bool:
        return self._done.is_set()

    def ok(self) -> bool:
        """The pass finished and every signature warmed."""
        return self._done.is_set() and self.errors == 0

    def progress(self) -> dict:
        return {"planned": len(self._plan), "warmed": self.warmed,
                "pending": len(self._plan) - self.warmed - self.errors,
                "errors": self.errors, "captured": self.captured, "eager": self.eager,
                "done": self.done(), "wall_s": self.wall_s}

    def _emit(self, phase: str, **fields) -> None:
        _metrics.emit({"event": "warmup", "v": _metrics.SCHEMA_VERSION, "phase": phase,
                       "run_id": self.run_id, **fields})

    def _error(self, fn, e, **fields) -> None:
        self.errors += 1
        self._errors_c.inc()
        self._emit("signature", fn=fn, status="error", error=f"{type(e).__name__}: {e}",
                   **fields)

    def _run(self) -> None:
        t0 = time.perf_counter()
        self._emit("start", planned=len(self._plan))
        obs.instant("warmup_start", planned=len(self._plan))
        if self._prime is not None and not self._stop.is_set():
            try:
                primed = self._prime()
            except Exception as e:
                self._error("sign_cache_prime", e)
            else:
                self._reg.gauge("serve_warmup_sign_cache_rounds").set(int(primed or 0))
        for fn, axes in self._plan:
            if self._stop.is_set():
                break
            while self._gate is not None and not self._gate():
                if self._stop.wait(self._pause_s):
                    break
            if self._stop.is_set():
                break
            try:
                info = self._cache.ensure(fn, axes, builder_for(fn, self._device))
            except Exception as e:
                self._error(fn, e, axes=dict(axes))
            else:
                self.warmed += 1
                self._warmed_c.inc()
                if info["status"] == "captured":
                    self.captured += 1
                elif info["status"] == "eager":
                    self.eager += 1
                self._emit("signature", fn=fn, axes=dict(axes), status=info["status"],
                           wall_s=round(info.get("wall_s", 0.0), 6))
            self._reg.gauge("serve_warmup_pending").set(
                len(self._plan) - self.warmed - self.errors)
        self.wall_s = time.perf_counter() - t0
        self._emit("done", planned=len(self._plan), warmed=self.warmed,
                   captured=self.captured, eager=self.eager, errors=self.errors,
                   stopped=self._stop.is_set(), wall_s=round(self.wall_s, 6))
        obs.instant("warmup_done", warmed=self.warmed, errors=self.errors)
        self._done.set()
