"""Agreement as a service (``ba_tpu/runtime/serve.py``): the overload-safe
serving front-end with continuous batching, on the port's engine.

Many callers share one process:

- **Continuous batching.**  Concurrent ``actual-order``, ``run-rounds``
  and ``scenario`` requests with one cohort key (:func:`cohort_key`:
  scenario-ness, rounds, padded capacity, engine, m, signed) coalesce
  into one padded batch: rosters pad to power-of-two capacities, cohorts
  to power-of-two batch buckets.  The engine entry is
  ``parallel.pipeline.coalesced_sweep``, whose per-slot key schedules
  make every result bit-identical to the same request run alone at equal
  padded capacity; on the card oral OM(1) cohorts run through K1's slot
  mode.
- **Deadlines.**  An expired request is cancelled before its cohort
  dispatches (:class:`DeadlineExceeded`), never after.
- **Admission and backpressure.**  The queue is bounded (``max_queue``);
  a refused admission raises :class:`Overloaded` with a ``retry_after_s``
  hint.  Pressure is read from the health sampler (``obs/health.py``):
  the pipelined loop's depth occupancy and retire-lag p99, and the
  queue's occupancy.
- **Shedding tiers** (:func:`shed_tier`): tier 1 halves the coalescing
  window, tier 2 sheds interactive requests (campaigns still admit),
  tier 3 rejects everything.
- **Per-cohort fault isolation.**  Each dispatch goes through
  :meth:`AgreementService._seam`: chaos injection for drills, and
  in-place retry of a transient fault with the supervisor's backoff
  (``runtime/supervisor.py``); a cohort that exhausts its retries fails
  only its own requests.
- **Warm serving.**  With ``warm=True``, :meth:`AgreementService.open`
  starts a background warmup (``runtime/warmup.py``) that makes the
  bucket lattice warm in a ``GraphCache`` (``obs/graphcache.py``): CUDA
  graphs of K1's slot-mode dispatch, eager entries for the rest.  The
  dispatcher consults it before every dispatch; after
  :meth:`AgreementService.warm_barrier` a warm service counts no compile
  on the request path (``serve_compile_on_request_path_total``).

- **SLO engine.**  With ``slo`` set (True: ``obs.slo.default_policy()``;
  a policy file's path; an ``SLOPolicy``) the service makes an
  ``obs/slo.py`` engine, installs it process-wide at ``open()`` (the
  health sampler's report hook), folds every terminal ``request`` record
  and every rejected ``admission`` record into it, stamps its queue
  pressure before each health sample, reads its ``health_slo_burn``
  gauge into the shed ladder (``burn_soft`` / ``burn_hard``), and at
  ``stop()`` forces a last report and uninstalls it.
- **Compile ledger.**  ``compile_ledger=path`` turns on the cross-run
  ledger (``obs/instrument.configure_compile_ledger``) for the service's
  life, before the warmup plan is made, so the warmup replays what an
  earlier process dispatched (``runtime/warmup.ledger_replay_set``).

The JAX package's environment knobs are :class:`ServeConfig` fields:
``BA_TPU_SERVE_BATCH`` / ``_QUEUE`` / ``_WINDOW_S`` / ``_DEADLINE_S`` /
``_RETRIES`` are ``max_batch``, ``max_queue``, ``coalesce_window_s``,
``default_deadline_s`` and ``max_retries``; ``BA_TPU_WARM`` is ``warm``;
``BA_TPU_ENGINE`` is ``engine`` (``torch``, ``cuda`` or ``auto``, the
default); ``BA_TPU_SLO`` is ``slo``; the ledger the reference keeps
beside its persistent XLA cache is ``compile_ledger``.  ``device``
places the cohorts (the card unless given).  ``aot_cache=`` is refused
with a ``ValueError`` (a CUDA graph lives in one process; the kernel
build directory is the persistent part).  The dispatcher thread alone
touches the card: callers' threads validate, queue and wait.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import numpy as np

from ba_tpu_torch import obs
from ba_tpu_torch.scenario.compile import compile_scenario, empty_block
from ba_tpu_torch.utils import metrics as _metrics

# runtime.supervisor (fault classes, backoff) is imported in the functions
# that use it: its own lazy seam reaches the engine, and this module's
# import stays host-tier (ba-lint BA301).

REQUEST_KINDS = ("actual-order", "run-rounds", "scenario")
ORDERS = ("attack", "retreat")
ENGINE_TOKENS = ("torch", "cuda", "auto")
# The retry-after hint of a service that has not finished a batch yet.
COLD_RETRY_AFTER_S = 0.1
_ORDER_VALUES = {"retreat": 0, "attack": 1}  # core/types: RETREAT, ATTACK


class ServeError(RuntimeError):
    """The service could not accept or complete a request."""


class Overloaded(ServeError):
    """Admission refused (queue full or shed), with ``retry_after_s``,
    ``tier`` and ``reason``."""

    def __init__(self, message, *, retry_after_s, tier, reason):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tier = tier
        self.reason = reason


class DeadlineExceeded(ServeError):
    """The request's deadline expired before its cohort dispatched."""


class RequestFailed(ServeError):
    """The request's cohort exhausted its retries; ``fault`` is the
    ``supervisor.classify_fault`` class."""

    def __init__(self, message, *, fault):
        super().__init__(message)
        self.fault = fault


def _capacity(n: int) -> int:
    """Power-of-two roster capacity, floor 4 (the interactive backends'
    padding)."""
    cap = 4
    while cap < n:
        cap *= 2
    return cap


def _batch_bucket(n: int) -> int:
    """Power-of-two batch bucket: cohorts of 3 and 4 share one shape."""
    b = 1
    while b < n:
        b *= 2
    return b


def _positive_ints(name, values) -> None:
    for v in values:
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name} entry {v!r} must be an int >= 1")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving dials, validated when made (module docstring for the JAX
    package's variables they replace)."""

    max_batch: int = 8
    max_queue: int = 64
    coalesce_window_s: float = 0.005
    default_deadline_s: float | None = 30.0
    queue_soft_frac: float = 0.5
    queue_hard_frac: float = 0.875
    lag_soft_s: float = 1.0
    lag_hard_s: float = 5.0
    depth: int = 2
    rounds_per_dispatch: int = 8
    m: int = 1
    max_retries: int | None = None   # None: SupervisorConfig's (3)
    dispatch_timeout_s: float | None = None  # None: supervisor.derive_timeout_s
    warm: bool = False
    warm_capacities: tuple = (4,)
    warm_rounds: int | None = None
    warm_scenarios: bool = True
    warm_signed: bool = True
    warm_ms: tuple | None = None
    aot_cache: str | None = None     # refused: no on-disk graph cache
    engine: str = "auto"
    slo: object = None               # None / False: no engine; True, a path or an SLOPolicy
    burn_soft: float = 1.0
    burn_hard: float = 8.0
    device: str | None = None        # the cohorts' device; None: the card
    compile_ledger: str | None = None  # the cross-run compile ledger's file; None: off

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch} must be >= 1")
        if self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")
        if self.coalesce_window_s < 0:
            raise ValueError(f"coalesce_window_s={self.coalesce_window_s} must be >= 0")
        if self.default_deadline_s is not None and self.default_deadline_s < 0:
            raise ValueError(f"default_deadline_s={self.default_deadline_s} must be >= 0")
        if not 0 < self.queue_soft_frac <= self.queue_hard_frac <= 1.0:
            raise ValueError(f"need 0 < queue_soft_frac <= queue_hard_frac <= 1, got "
                             f"{self.queue_soft_frac}/{self.queue_hard_frac}")
        if not 0 < self.lag_soft_s <= self.lag_hard_s:
            raise ValueError(f"need 0 < lag_soft_s <= lag_hard_s, got "
                             f"{self.lag_soft_s}/{self.lag_hard_s}")
        if self.dispatch_timeout_s is not None and self.dispatch_timeout_s <= 0:
            raise ValueError(f"dispatch_timeout_s={self.dispatch_timeout_s} must be > 0")
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if self.warm_rounds is not None and self.warm_rounds < 1:
            raise ValueError(f"warm_rounds={self.warm_rounds} must be >= 1")
        _positive_ints("warm_capacities", self.warm_capacities)
        if self.warm_ms is not None:
            _positive_ints("warm_ms", self.warm_ms)
        if self.engine not in ENGINE_TOKENS:
            raise ValueError(f"engine={self.engine!r} not in {ENGINE_TOKENS}")
        if (self.slo is not None and not isinstance(self.slo, (bool, str))
                and not hasattr(self.slo, "objectives")):
            raise ValueError(f"slo={self.slo!r} must be None, a bool, a policy path, or an "
                             f"obs.slo.SLOPolicy")
        if self.compile_ledger is not None and (not isinstance(self.compile_ledger, str)
                                                or not self.compile_ledger):
            raise ValueError(f"compile_ledger={self.compile_ledger!r} must be None or a path")
        if self.aot_cache is not None:
            raise ValueError("aot_cache= has no meaning in ba_tpu_torch: a CUDA graph is "
                             "local to one process, so warm entries are kept in memory "
                             "(obs/graphcache.py) and the kernel build directory is the "
                             "persistent part")
        if not 0 < self.burn_soft <= self.burn_hard:
            raise ValueError(f"need 0 < burn_soft <= burn_hard, got "
                             f"{self.burn_soft}/{self.burn_hard}")

    def resolved_max_retries(self) -> int:
        from ba_tpu_torch.runtime import supervisor as _supervisor

        if self.max_retries is not None:
            return self.max_retries
        return _supervisor.SupervisorConfig().max_retries


def shed_tier(queue_frac, lag_p99_s, occupancy, config: ServeConfig, burn=None) -> int:
    """The shedding tier from the pressure signals: 3 when the queue is
    full; 2 past ``queue_hard_frac``, ``lag_hard_s`` (inf counts) or
    ``burn_hard``; 1 past the soft limits or with every pipeline slot
    full (occupancy >= depth); else 0.  An absent signal (None) never
    raises the tier; ``burn`` is the SLO engine's gate burn (the
    ``health_slo_burn`` gauge), None without an engine."""
    if queue_frac >= 1.0:
        return 3
    lag_hard = lag_p99_s is not None and lag_p99_s >= config.lag_hard_s
    burn_hard = burn is not None and burn >= config.burn_hard
    if queue_frac >= config.queue_hard_frac or lag_hard or burn_hard:
        return 2
    lag_soft = lag_p99_s is not None and lag_p99_s >= config.lag_soft_s
    burn_soft = burn is not None and burn >= config.burn_soft
    saturated = occupancy is not None and occupancy >= config.depth
    if queue_frac >= config.queue_soft_frac or lag_soft or burn_soft or saturated:
        return 1
    return 0


@dataclasses.dataclass(frozen=True)
class AgreementRequest:
    """One caller's request: its own cluster of ``n`` generals (ids
    1..n, ``faulty`` roster indices, leader the lowest id), order, seed
    and rounds.  ``spec`` (a ``ba_tpu_torch.scenario`` spec) is required
    for ``kind="scenario"`` and sets the rounds there.  ``engine`` and
    ``m`` override the service's (None: its own) and join the cohort key,
    as ``signed`` does; ``tenant`` is an accounting label and
    ``traceparent`` an external caller's trace position, neither in the
    cohort key."""

    kind: str = "actual-order"
    order: str = "attack"
    n: int = 4
    faulty: tuple = ()
    seed: int = 0
    rounds: int = 1
    spec: object = None
    engine: str | None = None
    m: int | None = None
    signed: bool = False
    tenant: str | None = None
    traceparent: str | None = None


def validate_request(req: AgreementRequest) -> AgreementRequest:
    """Raise ValueError for a malformed request, before admission."""
    if req.kind not in REQUEST_KINDS:
        raise ValueError(f"kind {req.kind!r} not in {REQUEST_KINDS}")
    if req.order not in ORDERS:
        raise ValueError(f"order {req.order!r} not in {ORDERS}")
    if req.n < 1:
        raise ValueError(f"n={req.n} must be >= 1")
    for i in req.faulty:
        if not isinstance(i, int) or isinstance(i, bool) or not 0 <= i < req.n:
            raise ValueError(f"faulty index {i!r} outside roster [0, {req.n})")
    if req.engine is not None and req.engine not in ENGINE_TOKENS:
        raise ValueError(f"engine={req.engine!r} not in {ENGINE_TOKENS}")
    if req.m is not None and (not isinstance(req.m, int) or isinstance(req.m, bool)
                              or req.m < 1):
        raise ValueError(f"m={req.m!r} must be an int >= 1 (or None)")
    if req.tenant is not None and (not isinstance(req.tenant, str) or not req.tenant):
        raise ValueError(f"tenant={req.tenant!r} must be None or a non-empty string")
    if req.traceparent is not None and not isinstance(req.traceparent, str):
        raise ValueError(f"traceparent={req.traceparent!r} must be None or a string")
    if req.kind == "scenario":
        if req.spec is None:
            raise ValueError("kind='scenario' needs a spec")
        if req.signed:
            raise ValueError("signed requests cannot carry a scenario (the signed "
                             "megastep has no mutating-round form)")
    elif req.spec is not None:
        raise ValueError(f"kind={req.kind!r} does not take a spec")
    if req.kind == "actual-order" and req.rounds != 1:
        raise ValueError(f"actual-order is one round; rounds={req.rounds} "
                         f"(use kind='run-rounds')")
    if req.rounds < 1:
        raise ValueError(f"rounds={req.rounds} must be >= 1")
    return req


def request_rounds(req: AgreementRequest) -> int:
    return req.spec.rounds if req.kind == "scenario" else req.rounds


def cohort_key(req: AgreementRequest, default_engine: str = "auto",
               default_m: int = 1) -> tuple:
    """Requests with equal keys coalesce: (scenario?, rounds, padded
    capacity, engine, m, signed).  Orders, seeds, faults and event planes
    are per-slot data."""
    return (req.kind == "scenario", request_rounds(req), _capacity(req.n),
            req.engine or default_engine, default_m if req.m is None else req.m,
            bool(req.signed))


def cohort_label(key: tuple) -> str:
    """``{scenario|plain}.r<rounds>.c<capacity>.<engine>.m<m>[.signed]``."""
    is_scenario, rounds, cap, engine, m, signed = key
    label = f"{'scenario' if is_scenario else 'plain'}.r{rounds}.c{cap}.{engine}.m{m}"
    return label + ".signed" if signed else label


class Ticket:
    """The caller's handle (a small future): ``result(timeout)`` returns
    the result dict or raises the request's failure."""

    def __init__(self, request, req_id, deadline_t):
        self.request = request
        self.id = req_id
        self.deadline_t = deadline_t  # perf_counter deadline, or None
        # admitted -> popped -> dispatched -> retired: the request record's
        # phases telescope over these marks
        self.enqueued_t = time.perf_counter()
        self.popped_t = None
        self.dispatched_t = None
        self.retired_t = None
        self._trace = obs.trace.new_context(request.traceparent or None)
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._block = None  # the compiled scenario planes of a scenario request
        self._on_fail = None  # fail hook(ticket, error): the fleet router's re-homing

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _fail(self, error) -> None:
        self._error = error
        self._event.set()
        hook = self._on_fail
        if hook is not None:
            hook(self, error)


class AgreementService:
    """The long-lived, thread-safe serving front-end::

        svc = AgreementService(ServeConfig(device="cpu"))
        svc.start()
        out = svc.submit(AgreementRequest(kind="run-rounds", n=4, rounds=32,
                                          seed=7)).result(timeout=60)
        svc.stop()

    ``fault_plan`` (a ``runtime.chaos.FaultPlan`` or a live
    ``ChaosInjector``) injects engine-phase faults into every cohort's
    dispatches.  ``open()`` alone admits without a dispatcher (the
    deterministic overload drill); a later ``start()`` drains the queue.
    The service owns the process-default signing pool's life: made at
    ``open()``, closed at ``stop()``.
    """

    def __init__(self, config: ServeConfig | None = None, fault_plan=None, registry=None):
        self._cfg = config or ServeConfig()
        self._reg = registry if registry is not None else obs.default_registry()
        self._cond = threading.Condition()
        # the queue depth at which a submission wakes the waiting dispatcher:
        # 1 while it idles, the slots its open window still lacks while it
        # coalesces, so a burst wakes it once and not once a request
        self._wake_at = 1
        # tier and wedge state: written by the dispatcher and the watchdog
        self._tier_lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._open = False
        self._drain = True
        self._thread = None
        self._tier = 0
        self._window_s = self._cfg.coalesce_window_s
        self._batch_s = None  # EWMA of a cohort's wall
        self._ids = itertools.count(1)
        # the engine's pipeline_* instruments live in the process-wide
        # registry whatever registry the serve_* family uses
        self._sampler = obs.health.HealthSampler()
        from ba_tpu_torch.runtime import supervisor as _supervisor

        self._sup_cfg = _supervisor.SupervisorConfig()
        self._max_retries = self._cfg.resolved_max_retries()
        self._dispatch_timeout_s = (self._cfg.dispatch_timeout_s
                                    if self._cfg.dispatch_timeout_s is not None
                                    else _supervisor.derive_timeout_s(self._sup_cfg))
        self._wedged = False
        self._stalls_c = self._reg.counter("serve_stalls_total")
        self._device = None  # resolved at open()
        self._exec_cache = None
        self._warmup = None
        self._compile_rp_c = self._reg.counter("serve_compile_on_request_path_total")
        self._warm_miss_c = self._reg.counter("serve_warmup_miss_total")
        self._fallback_c = self._reg.counter("serve_graph_fallbacks_total")
        self._rpc_n = 0
        self._warm_miss_n = 0
        self._fallback_n = 0
        self._warm_dispatch_n = 0
        self._timing = {"execute_s": 0.0, "engine_s": 0.0, "result_build_s": 0.0,
                        "cohorts": 0, "slots": 0}
        injector = fault_plan
        if injector is not None and not hasattr(injector, "fire"):
            from ba_tpu_torch.runtime.chaos import ChaosInjector

            injector = ChaosInjector(injector)
        self._injector = injector
        # the SLO engine, made here so that a bad policy fails at
        # construction; installed at open()
        self._slo = None
        if self._cfg.slo:
            from ba_tpu_torch.obs import slo as _slo

            policy = self._cfg.slo
            if policy is True:
                policy = _slo.default_policy()
            elif isinstance(policy, str):
                policy = _slo.SLOPolicy.load(policy)
            self._slo = _slo.SLOEngine(policy, registry=self._reg)
        self._ledger = None  # the ledger path this service configured
        self._admitted_c = self._reg.counter("serve_admitted_total")
        self._completed_c = self._reg.counter("serve_completed_total")
        self._rejected_c = self._reg.counter("serve_rejected_total")
        self._expired_c = self._reg.counter("serve_expired_total")
        self._failed_c = self._reg.counter("serve_failed_total")
        self._retries_c = self._reg.counter("serve_retries_total")
        self._batches_c = self._reg.counter("serve_batches_total")
        self._slots_h = self._reg.histogram("serve_batch_slots", base=1.0, n_buckets=12)
        self._wait_h = self._reg.histogram("serve_queue_wait_s")
        self._latency_h = self._reg.histogram("serve_request_latency_s")
        self._reg.gauge("serve_queue_depth").set(0)
        self._reg.gauge("serve_shed_tier").set(0)
        self._reg.gauge("serve_window_s").set(self._window_s)

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> None:
        """Open admission without the dispatcher.  With ``warm`` this also
        starts the background warmup; admission never waits for it."""
        from ba_tpu_torch.core.state import resolve_device
        from ba_tpu_torch.crypto import pool as _pool

        if self._device is None:
            self._device = resolve_device(self._cfg.device)
        if self._cfg.compile_ledger and self._ledger is None:
            from ba_tpu_torch.ops import _build

            obs.configure_compile_ledger(self._cfg.compile_ledger)
            obs.instrument.report_compile_cache(str(_build.BUILD_DIR))
            self._ledger = self._cfg.compile_ledger
        with self._cond:
            self._open = True
        self._sampler.prime()
        if self._slo is not None:
            obs.slo.install(self._slo)
        pool = _pool.default_pool()
        self._reg.gauge("serve_sign_pool_workers").set(pool.workers if pool is not None else 0)
        if self._cfg.warm and self._warmup is None:
            from ba_tpu_torch.obs.graphcache import GraphCache
            from ba_tpu_torch.runtime import warmup as warmup_mod

            self._exec_cache = GraphCache(self._device)
            self._warmup = warmup_mod.WarmupRunner(
                self._exec_cache,
                warmup_mod.service_plan(self._cfg, self._device),
                # warm only while the service reads healthy: warmup never sheds
                gate=lambda: self._tier == 0 and not self._wedged,
                registry=self._reg,
                prime=warmup_mod.sign_cache_primer(self._cfg, self._device),
                device=self._device,
            )
            self._warmup.start()

    def warm_barrier(self, timeout: float | None = None) -> bool:
        """Block until the warmup attempted every planned signature (True;
        False on timeout).  A service without warmup is warm."""
        if self._warmup is None:
            return True
        return self._warmup.wait(timeout)

    def start(self) -> None:
        self.open()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="ba-torch-serve",
                                            daemon=True)
            self._thread.start()

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
        """Close admission; with ``drain`` the dispatcher finishes the
        queue first, otherwise queued tickets fail with ServeError."""
        from ba_tpu_torch.crypto import pool as _pool

        with self._cond:
            self._open = False
            self._drain = drain
            self._cond.notify_all()
        if self._warmup is not None:
            self._warmup.stop()
            self._warmup.join(timeout)
        if self._thread is not None:
            self._thread.join(timeout)
        _pool.close_default_pool()
        leftovers = []
        with self._cond:
            while self._queue:
                leftovers.append(self._queue.popleft())
            self._gauge_queue_locked()
        for t in leftovers:
            self._failed_c.inc()
            t._fail(ServeError("service stopped before dispatch"))
            self._emit_request(t, status="failed", fault=None)
        if self._slo is not None:
            # a last report (the leftovers folded in), then the hook goes
            self._slo.maybe_report(force=True)
            if obs.slo.installed() is self._slo:
                obs.slo.install(None)
        if self._ledger is not None:
            if obs.instrument.ledger_path() == self._ledger:
                obs.configure_compile_ledger(None)
            self._ledger = None

    def handoff(self, timeout: float | None = None) -> list:
        """Close admission, let the cohort in flight retire, and detach the
        queued tickets (failed with a ServeError that names the move, not
        counted, no ``request`` record): the fleet's drain hook.  The
        signing pool and the SLO hook are left alone."""
        leftovers = []
        with self._cond:
            self._open = False
            self._drain = False
            while self._queue:
                leftovers.append(self._queue.popleft())
            self._gauge_queue_locked()
            self._cond.notify_all()
        if self._warmup is not None:
            self._warmup.stop()
        if self._thread is not None:
            self._thread.join(timeout)
        for t in leftovers:
            t._fail(ServeError(f"request {t.id} re-homed: replica draining"))
        obs.instant("serve_handoff", rehomed=len(leftovers))
        return leftovers

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- admission -----------------------------------------------------------

    def submit(self, request: AgreementRequest, deadline_s=...) -> Ticket:
        """Admit one request or raise: validation, the bounded queue and
        the shed tiers, the deadline (``deadline_s``: the config's by
        default, None for none)."""
        validate_request(request)
        if deadline_s is ...:
            deadline_s = self._cfg.default_deadline_s
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s={deadline_s} must be >= 0")

        def check(depth, tier):
            if depth >= self._cfg.max_queue:
                return ("queue_full", depth, tier)
            if tier >= 3:
                return ("shed_all", depth, tier)
            if tier >= 2 and request.kind != "scenario":
                return ("shed_interactive", depth, tier)
            return None

        with self._cond:
            if not self._open:
                raise ServeError("service is not accepting requests (call start())")
            reject = check(len(self._queue), self._tier)
        block = None
        if reject is None and request.kind == "scenario":
            # lowered on the caller's thread: spec errors are the caller's
            cap = _capacity(request.n)
            block = compile_scenario(request.spec, batch=1, capacity=cap,
                                     ids=np.arange(1, cap + 1, dtype=np.int64))
        with self._cond:
            if not self._open:
                raise ServeError("service is not accepting requests (call start())")
            depth = len(self._queue)
            tier = self._tier
            if reject is None:
                reject = check(depth, tier)
            if reject is None:
                ticket = Ticket(request, next(self._ids),
                                None if deadline_s is None else time.perf_counter() + deadline_s)
                ticket._block = block
                self._queue.append(ticket)
                self._gauge_queue_locked()
                if len(self._queue) >= self._wake_at:
                    self._cond.notify_all()
        if reject is not None:
            reason, depth, tier = reject
            retry_after = self._retry_after(depth)
            self._rejected_c.inc()
            rec = {
                "event": "admission", "v": _metrics.SCHEMA_VERSION, "decision": "reject",
                "reason": reason, "kind": request.kind, "tenant": request.tenant,
                "cohort": cohort_label(cohort_key(request, self._cfg.engine, self._cfg.m)),
                "tier": tier, "queue_depth": depth, "queue_limit": self._cfg.max_queue,
                "retry_after_s": retry_after,
            }
            _metrics.emit(rec)
            if self._slo is not None:
                self._slo.fold(rec)
            obs.instant("serve_reject", reason=reason, tier=tier, queue=depth)
            raise Overloaded(
                f"overloaded ({reason}): queue {depth}/{self._cfg.max_queue}, shed tier "
                f"{tier} — retry in ~{retry_after}s",
                retry_after_s=retry_after, tier=tier, reason=reason)
        self._admitted_c.inc()
        return ticket

    def _retry_after(self, queue_depth: int) -> float:
        per_batch = self._batch_s if self._batch_s is not None else COLD_RETRY_AFTER_S
        batches_ahead = max(1, -(-max(1, queue_depth) // self._cfg.max_batch))
        return round(max(self._window_s, batches_ahead * per_batch), 4)

    def _gauge_queue_locked(self) -> None:
        self._reg.gauge("serve_queue_depth").set(len(self._queue))

    # -- the dispatcher thread -----------------------------------------------

    def _run(self) -> None:
        # the tier refresh runs on idle ticks too, so a storm's tier decays
        while True:
            self._refresh_tier()
            cohort = self._next_cohort()
            if cohort is None:
                break
            if cohort:
                self._dispatch_cohort(cohort)

    def _next_cohort(self):
        """Pop one cohort (None: shut down; []: nothing to dispatch).
        Expiry is checked at the pop and again just before returning."""
        expired = []
        cohort = []
        with self._cond:
            if self._open and not self._queue:
                self._wake_at = 1
                self._cond.wait(0.05)
            if not self._open and (not self._drain or not self._queue):
                return None
            if not self._queue:
                return []
            now = time.perf_counter()
            head = None
            while self._queue:
                t = self._queue.popleft()
                t.popped_t = now
                if t.deadline_t is not None and now >= t.deadline_t:
                    expired.append(t)
                    continue
                head = t
                break
            if head is not None:
                ckey = cohort_key(head.request, self._cfg.engine, self._cfg.m)
                cohort = [head]
                window_end = time.perf_counter() + self._window_s
                while len(cohort) < self._cfg.max_batch:
                    keep: collections.deque = collections.deque()
                    now = time.perf_counter()
                    while self._queue:
                        t = self._queue.popleft()
                        if t.deadline_t is not None and now >= t.deadline_t:
                            t.popped_t = now
                            expired.append(t)
                        elif (len(cohort) < self._cfg.max_batch
                              and cohort_key(t.request, self._cfg.engine, self._cfg.m) == ckey):
                            t.popped_t = now
                            cohort.append(t)
                        else:
                            keep.append(t)
                    self._queue = keep
                    if len(cohort) >= self._cfg.max_batch:
                        break
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0 or not self._open:
                        break
                    self._wake_at = self._cfg.max_batch - len(cohort)
                    self._cond.wait(remaining)
            self._gauge_queue_locked()
        for t in expired:
            self._expire(t)
        live = []
        now = time.perf_counter()
        for t in cohort:
            if t.deadline_t is not None and now >= t.deadline_t:
                self._expire(t)
            else:
                live.append(t)
        return live

    def _expire(self, ticket: Ticket) -> None:
        self._expired_c.inc()
        ticket._fail(DeadlineExceeded(
            f"request {ticket.id} expired after {time.perf_counter() - ticket.enqueued_t:.3f}s "
            f"in queue (cancelled before dispatch)"))
        self._emit_request(ticket, status="expired", fault=None)

    def _refresh_tier(self) -> None:
        """One health sample -> shed tier -> coalescing window; a wedged
        dispatcher holds tier 3 until its dispatch returns."""
        if self._wedged:
            return
        with self._cond:
            depth = len(self._queue)
        frac = depth / self._cfg.max_queue
        if self._slo is not None:
            # before the sample: the report it may trigger reads this pressure
            self._slo.queue_frac = frac
        snap = self._sampler.sample()
        burn_inst = self._reg.get("health_slo_burn")  # None until an engine reported
        tier = shed_tier(frac, snap.get("retire_lag_p99_s"), snap.get("depth_occupancy"),
                         self._cfg, burn=burn_inst.value if burn_inst is not None else None)
        if tier != self._tier:
            self._transition_tier(tier, depth, snap=snap, frac=frac)

    def _transition_tier(self, tier, depth, snap=None, frac=None, reason=None) -> None:
        """Apply and record one tier transition (the refresh's and the
        watchdog's)."""
        with self._tier_lock:
            prev, self._tier = self._tier, tier
            self._window_s = self._cfg.coalesce_window_s * (0.5 ** min(tier, 2))
        self._reg.gauge("serve_shed_tier").set(tier)
        self._reg.gauge("serve_window_s").set(self._window_s)
        lag = (snap or {}).get("retire_lag_p99_s")
        _metrics.emit({
            "event": "shed", "v": _metrics.SCHEMA_VERSION, "tier": tier, "prev_tier": prev,
            "window_s": round(self._window_s, 6), "queue_depth": depth,
            "queue_frac": round(frac if frac is not None else depth / self._cfg.max_queue, 4),
            "retire_lag_p99_s": None if lag == float("inf") else lag,
            "depth_occupancy": (snap or {}).get("depth_occupancy"),
            **({"reason": reason} if reason else {}),
        })
        obs.instant("serve_shed", tier=tier, prev=prev, queue=depth)

    def _declare_wedged(self, slots, lo_rounds) -> None:
        # the watchdog's timer thread: observe and apply backpressure
        # (tier 3 until the dispatch returns); it never touches the card
        with self._tier_lock:
            self._wedged = True
        self._stalls_c.inc()
        obs.instant("serve_dispatch_stalled", slots=slots, rounds=lo_rounds,
                    timeout_s=self._dispatch_timeout_s)
        with self._cond:
            depth = len(self._queue)
        if self._tier != 3:
            self._transition_tier(3, depth, reason="dispatcher_stalled")

    # -- cohort dispatch -----------------------------------------------------

    def _seam(self, call, phase, d, lo, hi):
        """The cohort's execution seam: chaos injection, then in-place
        retry of transient faults with the supervisor's backoff."""
        from ba_tpu_torch.runtime import supervisor as _supervisor

        wrapped = call if self._injector is None else (
            lambda: self._injector.fire(call, phase, lo, hi))
        tries = 0
        while True:
            try:
                return wrapped()
            except Exception as e:
                if (_supervisor.classify_fault(e) != _supervisor.TRANSIENT
                        or tries >= self._max_retries):
                    raise
                tries += 1
                self._retries_c.inc()
                time.sleep(_supervisor.backoff_s(self._sup_cfg, tries, f"serve:{phase}:{lo}"))

    def _dispatch_cohort(self, live) -> None:
        from ba_tpu_torch.runtime import supervisor as _supervisor

        t0 = time.perf_counter()
        for t in live:
            t.dispatched_t = t0
            self._wait_h.record(t0 - t.enqueued_t)
        rounds = request_rounds(live[0].request)
        # the batch's fan-in node: a child of the first member's trace,
        # with every member's root as a fan_in edge
        batch_ctx = obs.trace.child_context(live[0]._trace)
        fan_in = [t._trace[1] for t in live]
        watchdog = threading.Timer(self._dispatch_timeout_s, self._declare_wedged,
                                   args=(len(live), rounds))
        watchdog.daemon = True
        watchdog.start()
        try:
            try:
                with obs.trace.scope(batch_ctx):
                    results, run_id, phases = self._execute(live)
            except Exception as e:  # the cohort fails, the service goes on
                att = _supervisor.fault_attribution(e)
                self._failed_c.inc(len(live))
                obs.instant("serve_cohort_failed", fault=att["fault"], slots=len(live))
                obs.trace.emit_trace_span("serve_batch", batch_ctx, t0,
                                          time.perf_counter() - t0, fan_in=fan_in,
                                          slots=len(live), status="failed")
                for t in live:
                    t._fail(RequestFailed(
                        f"cohort of {len(live)} failed ({att['fault']}): {att['error']}",
                        fault=att["fault"]))
                    self._emit_request(t, status="failed", fault=att["fault"])
                return
        finally:
            watchdog.cancel()
            with self._tier_lock:
                self._wedged = False
        t_retired = time.perf_counter()
        for t in live:
            t.retired_t = t_retired
        wall = t_retired - t0
        obs.trace.emit_trace_span("serve_batch", batch_ctx, t0, wall, fan_in=fan_in,
                                  slots=len(live), status="ok")
        self._batch_s = wall if self._batch_s is None else 0.5 * self._batch_s + 0.5 * wall
        self._batches_c.inc()
        self._slots_h.record(len(live))
        self._completed_c.inc(len(live))
        for t, result in zip(live, results):
            t._resolve(result)
            self._latency_h.record(time.perf_counter() - t.enqueued_t)
            self._emit_request(t, status="ok", fault=None, batch=len(live),
                               slot=result["slot"], run_id=run_id, phases=phases)

    def _execute(self, live):
        """Stage and dispatch one cohort (the only code that touches the
        device): filler slots replicate slot 0 under ``key(0)``, and their
        results are dropped."""
        import torch

        from ba_tpu_torch.core import rng
        from ba_tpu_torch.core.state import SimState
        from ba_tpu_torch.parallel.pipeline import coalesced_sweep

        t_exec = time.perf_counter()
        is_scenario, rounds, cap, engine, m, signed = cohort_key(
            live[0].request, self._cfg.engine, self._cfg.m)
        n_live = len(live)
        B = min(_batch_bucket(n_live), _batch_bucket(self._cfg.max_batch))
        reqs = [t.request for t in live] + [live[0].request] * (B - n_live)
        order = np.zeros(B, np.int8)
        faulty = np.zeros((B, cap), np.bool_)
        alive = np.zeros((B, cap), np.bool_)
        for b, req in enumerate(reqs):
            order[b] = _ORDER_VALUES[req.order]
            alive[b, :req.n] = True
            faulty[b, list(req.faulty)] = True
        state = SimState(
            order=torch.from_numpy(order), leader=torch.zeros(B, dtype=torch.int32),
            faulty=torch.from_numpy(faulty), alive=torch.from_numpy(alive),
            ids=torch.arange(1, cap + 1, dtype=torch.int32).repeat(B, 1),
        )
        keys = [rng.key(req.seed, device="cpu") for req in reqs[:n_live]]
        keys += [rng.key(0, device="cpu")] * (B - n_live)
        planes = None
        if is_scenario:
            blocks = [t._block for t in live]
            fill = empty_block(rounds, B - n_live, cap) if B > n_live else None
            planes = {name: np.concatenate([getattr(b, name) for b in blocks]
                                           + ([getattr(fill, name)] if fill is not None else []),
                                           axis=1)
                      for name in ("kill", "revive", "set_faulty", "set_strategy")}
        t_eng = time.perf_counter()
        out = coalesced_sweep(
            keys, state, rounds, m=m, depth=self._cfg.depth,
            rounds_per_dispatch=self._cfg.rounds_per_dispatch, scenario=planes,
            signed=signed, exec_seam=self._seam, executables=self._exec_cache,
            engine=None if engine == "auto" else engine, device=self._device,
        )
        t_built = time.perf_counter()
        st = out["stats"]
        rpc = st.get("request_path_compiles", 0)
        if rpc:
            self._compile_rp_c.inc(rpc)
            self._rpc_n += rpc
        if self._exec_cache is not None:
            misses = st.get("warm_misses", 0)
            if misses:
                self._warm_miss_c.inc(misses)
                self._warm_miss_n += misses
            self._warm_dispatch_n += st.get("warm_dispatches", 0)
        if st.get("graph_fallbacks", 0):
            self._fallback_c.inc(st["graph_fallbacks"])
            self._fallback_n += st["graph_fallbacks"]
        decisions = out["decisions"][:, :n_live]
        n_attack = (decisions == _ORDER_VALUES["attack"]).sum(0).tolist()
        n_retreat = (decisions == _ORDER_VALUES["retreat"]).sum(0).tolist()
        dec_cols = decisions.T.tolist()
        counters = out["counters"][:n_live].tolist()
        names = out["counter_names"]
        leaders = out["leaders"][:, :n_live].T.tolist() if is_scenario else None
        results = []
        for i, t in enumerate(live):
            result = {
                "kind": t.request.kind,
                "rounds": rounds,
                "decisions": dec_cols[i],
                "counts": {"attack": n_attack[i], "retreat": n_retreat[i],
                           "undefined": rounds - n_attack[i] - n_retreat[i]},
                "majorities": out["majorities"][i, :t.request.n].tolist(),
                "counters": dict(zip(names, counters[i])),
                "batch": n_live,
                "slot": i,
                "run_id": st["run_id"],
            }
            if is_scenario:
                result["leaders"] = leaders[i]
            results.append(result)
        t_end = time.perf_counter()
        tm = self._timing
        tm["execute_s"] += t_end - t_exec
        tm["engine_s"] += t_built - t_eng
        tm["result_build_s"] += t_end - t_built
        tm["cohorts"] += 1
        tm["slots"] += n_live
        phases = {"compile_s": st.get("compile_s", 0.0),
                  "retire_fetch_s": st.get("retire_fetch_s", 0.0)}
        return results, st["run_id"], phases

    # -- records and stats ---------------------------------------------------

    def _emit_request(self, ticket, *, status, fault, batch=None, slot=None, run_id=None,
                      phases=None) -> None:
        # queue_s + coalesce_s + compile_s + dispatch_s + retire_lag_s of an
        # ok request telescopes to wall_s; other requests carry the phases
        # they reached (None for the rest)
        now = time.perf_counter()
        admitted, popped = ticket.enqueued_t, ticket.popped_t
        dispatched, retired = ticket.dispatched_t, ticket.retired_t
        queue_s = (popped if popped is not None else now) - admitted
        coalesce_s = compile_s = dispatch_s = retire_lag_s = None
        if popped is not None and dispatched is not None:
            coalesce_s = dispatched - popped
        if status == "ok" and dispatched is not None and retired is not None:
            compile_s = (phases or {}).get("compile_s", 0.0)
            fetch_s = (phases or {}).get("retire_fetch_s", 0.0)
            dispatch_s = max(0.0, (retired - dispatched) - compile_s - fetch_s)
            retire_lag_s = fetch_s + (now - retired)
        elif status == "failed" and dispatched is not None:
            dispatch_s = now - dispatched

        def r6(v):
            return None if v is None else round(v, 6)

        rec = {
            "event": "request", "v": _metrics.SCHEMA_VERSION, "id": ticket.id,
            "kind": ticket.request.kind, "status": status,
            "rounds": request_rounds(ticket.request), "tenant": ticket.request.tenant,
            "cohort": cohort_label(cohort_key(ticket.request, self._cfg.engine, self._cfg.m)),
            "queue_s": round(queue_s, 6), "coalesce_s": r6(coalesce_s),
            "compile_s": r6(compile_s), "dispatch_s": r6(dispatch_s),
            "retire_lag_s": r6(retire_lag_s), "wall_s": round(now - admitted, 6),
        }
        if fault is not None:
            rec["fault"] = fault
        if batch is not None:
            rec["batch"] = batch
        if slot is not None:
            rec["slot"] = slot
        if run_id is not None:
            rec["run_id"] = run_id
        tctx = ticket._trace
        rec["trace_id"], rec["span_id"] = tctx[0], tctx[1]
        if tctx[2] is not None:
            rec["parent_id"] = tctx[2]
        _metrics.emit(rec)
        if self._slo is not None:
            self._slo.fold(rec)

    def stats(self) -> dict:
        with self._cond:
            depth = len(self._queue)
        out = {
            "open": self._open,
            "running": self.running(),
            "tier": self._tier,
            "window_s": round(self._window_s, 6),
            "queue_depth": depth,
            "queue_limit": self._cfg.max_queue,
            "max_batch": self._cfg.max_batch,
            "admitted": self._admitted_c.value,
            "completed": self._completed_c.value,
            "rejected": self._rejected_c.value,
            "expired": self._expired_c.value,
            "failed": self._failed_c.value,
            "retries": self._retries_c.value,
            "stalls": self._stalls_c.value,
            "batches": self._batches_c.value,
            "batch_s_ewma": round(self._batch_s, 6) if self._batch_s else None,
            "injected": len(self._injector.fired) if self._injector is not None else 0,
            "compiles_on_request_path": self._rpc_n,
            "warm": self._cfg.warm,
            "slo": self._slo is not None,
            "slo_reports": self._slo.reports if self._slo is not None else 0,
            "engine": self._cfg.engine,
        }
        if self._warmup is not None:
            prog = self._warmup.progress()
            out.update(warmup_planned=prog["planned"], warmup_warmed=prog["warmed"],
                       warmup_pending=prog["pending"], warmup_errors=prog["errors"],
                       warmup_done=prog["done"], warmup_misses=self._warm_miss_n)
        return out

    def warm_stats(self) -> dict:
        """The warm path's tallies (not in :meth:`stats`, whose keys are the
        JAX package's): warm dispatches, graph fallbacks, graphs captured,
        eager entries, the warmup's wall."""
        prog = self._warmup.progress() if self._warmup is not None else {}
        return {"warm_dispatches": self._warm_dispatch_n, "graph_fallbacks": self._fallback_n,
                "graphs_captured": prog.get("captured", 0), "eager_entries": prog.get("eager", 0),
                "warmup_wall_s": prog.get("wall_s")}

    def timings(self) -> dict:
        """Host walls summed over the cohorts served: ``execute_s`` (staging,
        the engine, the results), ``engine_s`` (``coalesced_sweep``),
        ``result_build_s`` (the result dicts), ``cohorts``, ``slots``."""
        return dict(self._timing)
