"""The execution supervisor (``ba_tpu/runtime/supervisor.py``): drive a
long campaign to its end through raised errors, stalls, killed processes
and damaged checkpoints.

:func:`supervised_sweep` runs ``pipeline_sweep`` (or a scenario campaign)
in attempts, all inside one run scope, and installs itself in the
engine's seams:

1. **Detection.**  A watchdog on every retire fetch
   (``pipeline_sweep(retire_timeout_s=)``): a fetch that outlasts
   :func:`derive_timeout_s` is a stall, counted and reported.  Raised
   errors classify (:func:`classify_fault`) as ``transient``, ``fatal``
   or ``oom``: an error's ``ba_tpu_fault`` attribute wins (chaos-injected
   faults carry one), then ``torch.cuda.OutOfMemoryError`` (or its
   message) is OOM, then the transient message markers; anything else is
   fatal, the safe default.
2. **Retry in place** (``exec_seam``): a transient fault at a dispatch or
   a retire is retried up to ``max_retries`` times with :func:`backoff_s`
   delays (exponential, jitter from sha256 of (seed, site, attempt): the
   same delays as the JAX package's for the same triple).  A retry is
   bit-exact because an injected fault fires before the real call, and a
   dispatch whose real call had begun refuses to run again
   (``pipeline.CarryConsumed``, fatal): the megasteps update their carry
   in place, so the retry would read a half-written carry.
3. **Recovery.**  An error that escapes the seam resumes the campaign
   from the newest checkpoint that validates and belongs to it
   (``snapshot.newest_valid_checkpoint``: a corrupt file is quarantined
   to ``<path>.corrupt`` and the scan falls back), or from round 0.  The
   retired rows (``pipeline_sweep(on_rows=)``) are kept in memory and
   written beside each checkpoint as ``<ckpt>.rows.npz`` sidecars (a
   delta since the previous checkpoint on a ``{round}`` family), so the
   stitched result is bit-identical to an uninterrupted run, across a
   process boundary too (``resume="auto"``).  Each recovery writes a
   ``{"event": "recovery", "v": 1}`` record.
4. **Degradation.**  An OOM halves ``depth`` first, then
   ``rounds_per_dispatch``, and retries: schedule dials only, so the
   result stays bit-exact.  The batch is never cut.

A window that fails ``poison_threshold`` times at the same round cursor
raises :class:`PoisonousWindow` with a minimal reproducer, also written as
``poison_<round>.json`` beside the checkpoints.

A sticky CUDA error (an illegal address, a device-side assert) poisons
the process's CUDA context: every resume in the process fails again until
the recovery budget ends in :class:`SupervisorError`.  Recovery from it
is a new process and ``resume="auto"``, as for a hung fetch; nothing here
resets the context.

The rows sidecars (``"ba_tpu.rows_sidecar"`` v1), the campaign
fingerprint stamped into every checkpoint header (``campaign_sha256``),
the stream names and the supervised run id are the JAX package's, so a
family written by either package is completed by the other.  The JAX
package's ``BA_TPU_MAX_RETRIES``, ``BA_TPU_SUPERVISE_TIMEOUT_S``,
``BA_TPU_RUN_ID`` and ``BA_TPU_TRACE_CONTEXT`` are
:class:`SupervisorConfig`'s ``max_retries`` and ``timeout_s`` and
:func:`supervised_sweep`'s ``run_id=`` and ``traceparent=``.

Supervision adds bookkeeping to a campaign without faults, never a
synchronization: the dispatches and retire waits are the unsupervised
run's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

from ba_tpu_torch import obs
from ba_tpu_torch.utils import metrics as _metrics
from ba_tpu_torch.utils import snapshot as _snapshot

TRANSIENT = "transient"
FATAL = "fatal"
OOM = "oom"

OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
               "CUBLAS_STATUS_ALLOC_FAILED")
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "Connection reset",
    "Socket closed",
    "failed to connect",
)

ROWS_SIDECAR_FORMAT = "ba_tpu.rows_sidecar"
ROWS_SIDECAR_VERSION = 1
# the engine's retire streams -> the stitched result's keys
_STREAM_RESULT_KEYS = {"histograms": "histograms", "leaders": "leaders",
                       "counter_rows": "counters_per_round", "decisions": "decisions"}


class SupervisorError(RuntimeError):
    """The supervisor gave up: a retry, recovery or degrade budget ran out."""


class PoisonousWindow(SupervisorError):
    """The same campaign window failed ``poison_threshold`` times; its
    minimal reproducer is ``.reproducer``."""

    def __init__(self, message: str, reproducer: dict):
        super().__init__(message)
        self.reproducer = reproducer


def _is_cuda_oom(exc: BaseException) -> bool:
    import sys

    torch = sys.modules.get("torch")  # an OOM can only come from a loaded torch
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom_type is not None and isinstance(exc, oom_type)


def classify_fault(exc: BaseException) -> str:
    """``transient`` | ``fatal`` | ``oom`` for a raised execution error
    (module docstring for the precedence)."""
    marker = getattr(exc, "ba_tpu_fault", None)
    if marker in (TRANSIENT, FATAL, OOM):
        return marker
    if _is_cuda_oom(exc):
        return OOM
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in OOM_MARKERS):
        return OOM
    if any(m in text for m in TRANSIENT_MARKERS):
        return TRANSIENT
    return FATAL


def fault_attribution(exc: BaseException) -> dict:
    """``{"fault": <classification>, "error": "<Type>: <msg>"}``, the
    text cut at 200 characters."""
    return {"fault": classify_fault(exc), "error": f"{type(exc).__name__}: {exc}"[:200]}


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Supervision dials.  ``max_retries``: in-place transient retries a
    site (the JAX package's ``BA_TPU_MAX_RETRIES``, default 3);
    ``timeout_s``: the watchdog's pin (its ``BA_TPU_SUPERVISE_TIMEOUT_S``),
    None to derive it; ``max_recoveries`` checkpoint resumes and
    ``max_degrades`` OOM halvings a campaign; ``poison_threshold``
    failures at one round cursor quarantine the window."""

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    jitter_frac: float = 0.25
    seed: int = 0
    timeout_s: float | None = None
    timeout_multiplier: float = 16.0
    timeout_floor_s: float = 30.0
    max_recoveries: int = 8
    max_degrades: int = 2
    poison_threshold: int = 3

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s={self.timeout_s} must be > 0")


def backoff_s(cfg: SupervisorConfig, attempt: int, token: str) -> float:
    """Exponential backoff (``attempt`` >= 1) with deterministic jitter:
    the same (seed, token, attempt) always draws the same delay."""
    if attempt < 1:
        raise ValueError(f"attempt={attempt} must be >= 1")
    raw = min(cfg.backoff_base_s * cfg.backoff_factor ** (attempt - 1), cfg.backoff_max_s)
    digest = hashlib.sha256(f"{cfg.seed}:{token}:{attempt}".encode()).digest()
    u = int.from_bytes(digest[:8], "big") / 2.0**63 - 1.0  # [-1, 1)
    return max(0.0, raw * (1.0 + cfg.jitter_frac * u))


def derive_timeout_s(cfg: SupervisorConfig, registry=None) -> float:
    """The watchdog timeout: the config's pin, else ``timeout_multiplier``
    times the worst dispatch latency this process has observed
    (``pipeline_dispatch_latency_s``), floored at ``timeout_floor_s``."""
    if cfg.timeout_s is not None:
        return float(cfg.timeout_s)
    reg = registry if registry is not None else obs.default_registry()
    snap = reg.snapshot().get("pipeline_dispatch_latency_s")
    if snap and snap.get("count") and snap.get("max"):
        return max(cfg.timeout_floor_s, cfg.timeout_multiplier * snap["max"])
    return cfg.timeout_floor_s


def _stream_names(scenario, collect_decisions, with_counters):
    """The engine's retire streams by name, in the megasteps' output order."""
    if scenario:
        return ["histograms", "leaders", "counter_rows"] + (
            ["decisions"] if collect_decisions else [])
    names = ["histograms"]
    if collect_decisions:
        names.append("decisions")
    if with_counters:
        names.append("counter_rows")
    return names


def _rows_sidecar_path(ckpt_path: str) -> str:
    return ckpt_path + ".rows.npz"


def _write_rows_sidecar(path, streams, start, upto, names) -> None:
    """Rows [start, upto) of the campaign beside a checkpoint, one stacked
    array a stream (atomic, versioned).  Derived data: no fsync, and a
    garbled sidecar fails its own schema check and costs history, never
    the resume."""
    arrays = dict(zip(names, streams))
    meta = {"format": ROWS_SIDECAR_FORMAT, "v": ROWS_SIDECAR_VERSION, "start": start,
            "round": upto, "streams": list(names)}

    def write(tmp):
        with open(tmp, "wb") as fh:
            np.savez(fh, __meta__=np.asarray(json.dumps(meta)), **arrays)

    _snapshot._atomic_write(path, write, durable=False)


def _read_rows_sidecar(path, names):
    """``(start, upto, [stream arrays])``, or None when the sidecar is
    missing or unusable."""
    try:
        with np.load(path, allow_pickle=False) as data:
            fields = {k: data[k] for k in data.files}
        meta = json.loads(str(fields.pop("__meta__")))
    except Exception:
        return None
    if (meta.get("format") != ROWS_SIDECAR_FORMAT or meta.get("v") != ROWS_SIDECAR_VERSION
            or meta.get("streams") != list(names)):
        return None
    start, upto = meta.get("start"), meta.get("round")
    if not (isinstance(start, int) and isinstance(upto, int)):
        return None
    if any(n not in fields or len(fields[n]) != upto - start for n in names):
        return None
    return start, upto, [fields[n] for n in names]


# The collected history is kept as the engine retires it: blocks[lo] =
# (hi, [stream arrays]) a dispatch window [lo, hi), the retire's own host
# arrays.  A replay after a recovery lands on the same lo grid and
# overwrites with equal data; after an OOM degrade the grid is finer and
# the cover below chains the finer blocks.


def _block_cover(blocks, start, end):
    """The block chain covering [start, end) as ``[(lo, hi, streams)]``,
    or None at a gap."""
    out, pos = [], start
    while pos < end:
        blk = blocks.get(pos)
        if blk is None or blk[0] <= pos:
            return None
        out.append((pos, blk[0], blk[1]))
        pos = blk[0]
    return out


def _slice_cover(cover, start, end, n_streams):
    """One stacked [end - start, ...] array a stream out of a chain."""
    parts = [[] for _ in range(n_streams)]
    for lo, hi, streams in cover:
        s, e = max(start, lo), min(end, hi)
        if s >= e:
            continue
        for i in range(n_streams):
            parts[i].append(streams[i][s - lo:e - lo])
    return [p[0] if len(p) == 1 else np.concatenate(p) for p in parts]


def _campaign_fingerprint(key, rounds, scenario):
    """sha256 of the campaign (the round count, the key data as the JAX
    package holds it, uint32 ``[2]``, and the scenario's document or dense
    planes), the JAX package's digest for the same campaign.  Stamped as
    ``campaign_sha256`` into every checkpoint a supervised run writes, and
    checked by ``resume="auto"``.  None without a key (an explicit
    resume)."""
    if key is None:
        return None
    import torch

    from ba_tpu_torch import convert

    h = hashlib.sha256()
    h.update(str(int(rounds)).encode())
    if isinstance(key, torch.Tensor):
        h.update(convert.key_data_to_numpy(key).tobytes())
    else:
        h.update(np.asarray(key).tobytes())
    if scenario is None:
        h.update(b"plain-sweep")
    elif hasattr(scenario, "to_doc"):
        h.update(json.dumps(scenario.to_doc(), sort_keys=True).encode())
    else:
        for name in ("kill", "revive", "set_faulty", "set_strategy"):
            h.update(np.asarray(getattr(scenario, name)).tobytes())
    return h.hexdigest()


def _read_rows_chain(ckpt_template, names):
    """Every readable delta sidecar of a ``{round}`` family, merged into a
    blocks dict.  Scans the sidecars themselves, not the checkpoints: the
    supervisor's retention prunes old carries and keeps their sidecars."""
    blocks = {}
    for _, path in _snapshot.checkpoint_paths(_rows_sidecar_path(ckpt_template)):
        side = _read_rows_sidecar(path, names)
        if side is not None:
            blocks[side[0]] = (side[1], side[2])
    return blocks


def supervised_sweep(  # ba-lint: donates(state)
        key, state, rounds: int | None = None, *, scenario=None, resume="auto",
        run_id: str | None = None, traceparent: str | None = None, **kwargs):
    """Run a campaign under supervision, every attempt inside one run
    scope.

    The run id is ``run_id``, else the active scope's, else (an explicit
    resume) the checkpoint's, else one derived from ``("supervised",
    campaign fingerprint, rounds)``: the JAX package's, so a killed
    process's successor in either package joins its ledger.  The scope's
    owner emits the ``flight_summary``; the id rides
    ``result["supervisor"]["run_id"]``.  ``traceparent`` is the trace
    position a fresh attempt adopts (a resumed one adopts its
    checkpoint's).  :func:`_supervised_sweep_impl` documents the rest.
    """
    n_rounds = rounds
    if n_rounds is None and scenario is not None:
        n_rounds = scenario.rounds
    inherited = None
    if key is None and resume is not None and resume != "auto":
        if isinstance(resume, (str, os.PathLike)):
            try:
                inherited = _snapshot.validate_carry_checkpoint(resume).get("run_id")
            except (OSError, ValueError):
                inherited = None
        else:
            inherited = getattr(resume, "run_id", None)

    def identity_material():
        fingerprint = (_campaign_fingerprint(key, n_rounds, scenario)
                       if key is not None and n_rounds is not None else None)
        return ("supervised", fingerprint or "", n_rounds)

    rid = obs.flight.resolve_run_id(run_id=run_id, inherited=inherited,
                                    material_fn=identity_material)
    with obs.flight.run_scope(rid) as scope:
        result = _supervised_sweep_impl(key, state, rounds, scenario=scenario, resume=resume,
                                        traceparent=traceparent, **kwargs)
        result["supervisor"]["run_id"] = scope.run_id
        if scope.owner:
            obs.flight.emit_flight_summary(run_id=scope.run_id)
    return result


def _recovery_record(fault, action, attempt, from_round, lost_rounds, error) -> None:
    obs.instant("recovery", fault=fault, action=action, attempt=attempt,
                from_round=from_round, lost_rounds=lost_rounds)
    _metrics.emit({"event": "recovery", "v": _metrics.SCHEMA_VERSION, "fault": fault,
                   "action": action, "attempt": attempt, "from_round": from_round,
                   "lost_rounds": lost_rounds, "error": error})


def _supervised_sweep_impl(  # ba-lint: donates(state)
    key,
    state,
    rounds: int | None = None,
    *,
    scenario=None,
    chaos=None,
    config: SupervisorConfig | None = None,
    collect_decisions: bool = False,
    with_counters: bool = False,
    depth: int = 2,
    rounds_per_dispatch: int = 1,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_keep_last: int | None = None,
    on_checkpoint=None,
    resume="auto",
    traceparent: str | None = None,
    **engine_kwargs,
):
    """Run ``pipeline_sweep`` under supervision.

    The engine's surface (``rounds`` defaults to ``scenario.rounds``;
    ``device``, ``engine``, ``mesh`` and every other dial pass through),
    plus:

    - ``chaos``: a ``runtime.chaos.FaultPlan`` (or a live injector, any
      object with ``fire(call, phase, lo, hi)``, ``after_checkpoint(round,
      path)`` and ``fired``) whose faults fire from the execution seam and
      the checkpoint hook;
    - ``config``: a :class:`SupervisorConfig`;
    - ``resume="auto"``: continue from the newest valid checkpoint of this
      campaign at ``checkpoint_path`` (a completed campaign replays its
      last window); a family that belongs to another campaign raises
      :class:`SupervisorError`.  ``resume=None`` starts afresh; a
      checkpoint or path behaves as the engine's ``resume=``.

    ``mesh=`` passes through: checkpoints are gathered on write and split
    on read, and the rows kept are the canonical blocks, so recovery is
    bit-exact at any device count.

    Returns the engine's result dict with the per-round arrays stitched
    across every attempt (bit-identical to an uninterrupted run when the
    history is whole), ``stats["checkpoints"]`` / ``["stalls"]`` counted
    over every attempt, and a ``"supervisor"`` block (attempts, retries,
    recoveries, degrades, stalls, lost rounds, the timeout, the final
    dials, the history's start and length, injected faults).  The
    caller's ``state`` is copied first and stays live.
    """
    from ba_tpu_torch.parallel.pipeline import fresh_copy, pipeline_sweep

    cfg = config or SupervisorConfig()
    if rounds is None:
        if scenario is None:
            raise ValueError("rounds is required without a scenario block")
        rounds = scenario.rounds
    for k in ("exec_seam", "on_rows", "retire_timeout_s", "on_stall", "checkpoint_meta"):
        if k in engine_kwargs:
            raise ValueError(f"{k} is owned by the supervisor")
    if scenario is not None:
        with_counters = True
    names = _stream_names(scenario is not None, collect_decisions, with_counters)
    if checkpoint_keep_last is not None:
        # the supervisor owns retention (sidecars kept), so the engine's
        # eager checks are made here
        if checkpoint_keep_last < 1:
            raise ValueError(f"checkpoint_keep_last={checkpoint_keep_last} must be >= 1")
        if checkpoint_every is None:
            raise ValueError("checkpoint_keep_last needs checkpoint_every")
        if "{round}" in os.path.dirname(checkpoint_path or ""):
            raise ValueError("checkpoint_path cannot carry the {round} slot in its "
                             "directory component (retention scans one directory)")
        if "{round}" not in os.path.basename(checkpoint_path or ""):
            raise ValueError("checkpoint_keep_last needs a {round}-templated checkpoint "
                             "FILENAME (the directory component cannot carry the slot)")

    injector = chaos
    if injector is not None and not hasattr(injector, "fire"):
        from ba_tpu_torch.runtime.chaos import ChaosInjector

        injector = ChaosInjector(injector)

    max_retries = cfg.max_retries
    timeout_s = derive_timeout_s(cfg)
    if timeout_s <= 0:
        raise ValueError(f"supervise timeout {timeout_s} must be > 0 "
                         f"(SupervisorConfig.timeout_s / timeout_floor_s)")
    reg = obs.default_registry()
    faults_c = reg.counter("supervisor_faults_total")
    retries_c = reg.counter("supervisor_retries_total")
    recoveries_c = reg.counter("supervisor_recoveries_total")
    degrades_c = reg.counter("supervisor_degrades_total")
    stalls_c = reg.counter("supervisor_stalls_total")
    quarantine_c = reg.counter("supervisor_quarantined_total")

    # a restart from round 0 needs the state the engine consumes
    master_state = fresh_copy(state) if state is not None else None

    blocks: dict = {}        # lo -> (hi, [stream arrays]) a retire
    history_start = 0        # the first round the kept history covers
    sidecar_upto = 0         # rows written to delta sidecars so far
    n_retries = n_stalls = n_checkpoints_total = 0
    n_recoveries = n_degrades = lost_rounds_total = 0
    window_failures: dict = {}
    cur_depth, cur_rpd = depth, rounds_per_dispatch

    fingerprint = _campaign_fingerprint(key, rounds, scenario)

    def accept_meta(meta):
        # only this campaign's members (or unstamped ones) seed a resume;
        # a foreign member is stepped over, never quarantined
        return fingerprint is None or meta.get("campaign_sha256") in (None, fingerprint)

    resume_arg = None
    resume_tp = None  # a resumed attempt's spans parent under the writer's position
    if resume == "auto":
        if checkpoint_path is not None:
            # below=rounds: a completed campaign's last checkpoint cannot
            # seed a resume, so a rerun replays the last window
            found = _snapshot.newest_valid_checkpoint(checkpoint_path, below=rounds,
                                                      accept=accept_meta)
            if found is None and fingerprint is not None:
                foreign = _snapshot.newest_valid_checkpoint(checkpoint_path, quarantine=False,
                                                            below=rounds)
                if foreign is not None:
                    stored = foreign[1].get("campaign_sha256")
                    obs.trace.flush_export()
                    raise SupervisorError(
                        f"checkpoint family at {checkpoint_path!r} belongs to a DIFFERENT "
                        f"campaign (stored fingerprint {(stored or '?')[:12]}..., this "
                        f"campaign {fingerprint[:12]}...) — resuming would silently splice "
                        f"its carry into this run; pass a fresh checkpoint_path (or "
                        f"resume=None to overwrite the family knowingly)")
            if found is not None:
                resume_arg = found[0]
                resume_tp = found[1].get("traceparent")
                r0 = found[1]["round"]
                if "{round}" in checkpoint_path:
                    blocks.update(_read_rows_chain(checkpoint_path, names))
                else:
                    side = _read_rows_sidecar(_rows_sidecar_path(found[0]), names)
                    if side is not None:
                        blocks[side[0]] = (side[1], side[2])
                if _block_cover(blocks, 0, r0) is None:
                    # no usable history: the result covers the tail only
                    # (the totals ride the carry and stay exact)
                    history_start = r0
                sidecar_upto = r0
                # the process boundary is a recovery nobody else records;
                # the recovery budget is untouched
                _recovery_record(FATAL, "resume", 0, r0, 0,
                                 "auto-resume: prior process left a valid checkpoint family")
    elif resume is not None:
        resume_arg = resume
        if isinstance(resume, (str, os.PathLike)):
            meta = _snapshot.validate_carry_checkpoint(resume)
            r0 = meta["round"]
            resume_tp = meta.get("traceparent")
        else:
            r0 = resume.round
        history_start = sidecar_upto = r0

    def on_stall_cb(d, t):
        nonlocal n_stalls
        n_stalls += 1
        stalls_c.inc()

    def on_rows_cb(d, lo, hi, host_ys):
        blocks[lo] = (hi, list(host_ys))

    def seam(call, phase, d, lo, hi):
        # in-place transient retry; a fault raised before the call is
        # bit-exact to retry, and a dispatch whose call began refuses a
        # second run (fatal, so it escalates to recovery)
        nonlocal n_retries
        wrapped = call if injector is None else (lambda: injector.fire(call, phase, lo, hi))
        tries = 0
        while True:
            try:
                return wrapped()
            except Exception as e:
                if classify_fault(e) != TRANSIENT or tries >= max_retries:
                    raise
                tries += 1
                n_retries += 1
                retries_c.inc()
                delay = backoff_s(cfg, tries, f"{phase}:{lo}")
                obs.instant("supervisor_retry", phase=phase, dispatch=d, lo=lo,
                            attempt=tries, delay_s=round(delay, 4))
                time.sleep(delay)

    def chained_on_checkpoint(round_cursor, path):
        # rows first (this retire's were delivered before the hook), then
        # chaos corruption of the real file, then the caller's hook
        nonlocal sidecar_upto, n_checkpoints_total
        n_checkpoints_total += 1
        if "{round}" in (checkpoint_path or ""):
            lo = min(sidecar_upto, round_cursor)
            cover = _block_cover(blocks, lo, round_cursor)
            if round_cursor > lo and cover is not None:
                _write_rows_sidecar(_rows_sidecar_path(path),
                                    _slice_cover(cover, lo, round_cursor, len(names)),
                                    lo, round_cursor, names)
                sidecar_upto = max(sidecar_upto, round_cursor)
        else:  # one file: nowhere to chain, so the whole prefix
            cover = _block_cover(blocks, history_start, round_cursor)
            if cover is not None:
                _write_rows_sidecar(_rows_sidecar_path(path),
                                    _slice_cover(cover, history_start, round_cursor, len(names)),
                                    history_start, round_cursor, names)
        if checkpoint_keep_last is not None:  # carries only: the sidecars are the history
            _snapshot.prune_checkpoints(checkpoint_path, checkpoint_keep_last,
                                        companions=False)
        if injector is not None:
            injector.after_checkpoint(round_cursor, path)
        if on_checkpoint is not None:
            on_checkpoint(round_cursor, path)

    def completed_round():
        # the high-water mark, stable across attempts: it keys poison
        done = history_start
        while True:
            blk = blocks.get(done)
            if blk is None or blk[0] <= done:
                return done
            done = blk[0]

    attempt = 0
    while True:
        attempt += 1
        # a resumed attempt takes its strategy plane from the carry
        attempt_kwargs = engine_kwargs
        if resume_arg is not None and "initial_strategy" in engine_kwargs:
            attempt_kwargs = {k: v for k, v in engine_kwargs.items()
                              if k != "initial_strategy"}
        try:
            with obs.trace.inject_scope(resume_tp or traceparent, mark="supervised_attempt"), \
                    obs.span("supervised_attempt", attempt=attempt,
                             start=0 if resume_arg is None else -1):
                res = pipeline_sweep(
                    None if resume_arg is not None else key,
                    None if resume_arg is not None else (
                        fresh_copy(master_state) if master_state is not None else None),
                    rounds,
                    scenario=scenario,
                    collect_decisions=collect_decisions,
                    with_counters=with_counters,
                    depth=cur_depth,
                    rounds_per_dispatch=cur_rpd,
                    checkpoint_every=checkpoint_every,
                    checkpoint_path=checkpoint_path,
                    checkpoint_keep_last=None,  # the supervisor's retention
                    checkpoint_meta=({"campaign_sha256": fingerprint}
                                     if checkpoint_every is not None and fingerprint is not None
                                     else None),
                    on_checkpoint=chained_on_checkpoint if checkpoint_every is not None else None,
                    exec_seam=seam,
                    retire_timeout_s=timeout_s,
                    on_stall=on_stall_cb,
                    on_rows=on_rows_cb,
                    resume=resume_arg,
                    **attempt_kwargs,
                )
            break
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            if isinstance(e, ValueError) and not hasattr(e, "ba_tpu_fault"):
                # a parameter error raises alike on every attempt
                obs.trace.flush_export()
                raise
            attribution = fault_attribution(e)
            kind = attribution["fault"]
            faults_c.inc()
            fail_round = completed_round()
            window_failures[fail_round] = window_failures.get(fail_round, 0) + 1
            if window_failures[fail_round] >= cfg.poison_threshold:
                _quarantine_window(e, kind, fail_round, rounds, cur_depth, cur_rpd,
                                   checkpoint_path, window_failures[fail_round],
                                   quarantine_c, accept_meta)
            action = "resume"
            if kind == OOM and n_degrades < cfg.max_degrades:
                # the schedule, never the batch: depth, then rounds a dispatch
                action = "degrade"
                n_degrades += 1
                degrades_c.inc()
                if cur_depth > 1:
                    cur_depth = max(1, cur_depth // 2)
                else:
                    cur_rpd = max(1, cur_rpd // 2)
            elif n_recoveries >= cfg.max_recoveries:
                obs.trace.flush_export()
                raise SupervisorError(
                    f"recovery budget exhausted after {n_recoveries} resume(s); last "
                    f"fault: {type(e).__name__}: {e}") from e
            else:
                n_recoveries += 1
                recoveries_c.inc()

            # the newest checkpoint that validates (corrupt ones are
            # quarantined), or round 0 when none survives
            resume_arg = resume_tp = None
            from_round = 0
            if checkpoint_path is not None:
                found = _snapshot.newest_valid_checkpoint(checkpoint_path, below=rounds,
                                                          accept=accept_meta)
                if found is not None:
                    resume_arg, from_round = found[0], found[1]["round"]
                    resume_tp = found[1].get("traceparent")
            if resume_arg is None:
                history_start = 0  # the restart computes [0, from_round) again
                if master_state is None:
                    obs.trace.flush_export()
                    raise SupervisorError(
                        f"cannot recover: no valid checkpoint at {checkpoint_path!r} and no "
                        f"initial state to restart from (the campaign was entered via an "
                        f"explicit resume=); last fault: {type(e).__name__}: {e}") from e
            # a quarantined checkpoint took its sidecar with it: the
            # replay writes those deltas again
            sidecar_upto = min(sidecar_upto, from_round)
            lost = max(0, fail_round - from_round)
            lost_rounds_total += lost
            _recovery_record(kind, action, attempt, from_round, lost, attribution["error"])
            if kind in (TRANSIENT, OOM):
                time.sleep(backoff_s(cfg, attempt, f"recover:{from_round}"))

    result = dict(res)
    if checkpoint_every is not None or n_stalls:
        # the engine's stats are the last attempt's; these span them all
        result["stats"] = dict(res["stats"], checkpoints=n_checkpoints_total, stalls=n_stalls)
    done = completed_round()
    cover = _block_cover(blocks, history_start, rounds)
    if cover is not None:
        stacked = _slice_cover(cover, history_start, rounds, len(names))
        for i, name in enumerate(names):
            result[_STREAM_RESULT_KEYS[name]] = stacked[i]
    result["supervisor"] = {
        "attempts": attempt,
        "retries": n_retries,
        "recoveries": n_recoveries,
        "degrades": n_degrades,
        "stalls": n_stalls,
        "lost_rounds": lost_rounds_total,
        "timeout_s": round(timeout_s, 6),
        "depth": cur_depth,
        "rounds_per_dispatch": cur_rpd,
        "history_start": history_start,
        "history_rounds": done - history_start,
        "injected": len(injector.fired) if injector is not None else 0,
    }
    return result


def _quarantine_window(exc, kind, fail_round, rounds, depth, rpd, checkpoint_path, failures,
                       quarantine_c, accept_meta):
    """Give up on a poisoned window: write its minimal reproducer and raise
    :class:`PoisonousWindow`."""
    quarantine_c.inc()
    newest = (_snapshot.newest_valid_checkpoint(checkpoint_path, below=rounds,
                                                accept=accept_meta)
              if checkpoint_path is not None else None)
    reproducer = {
        "window": [fail_round, min(rounds, fail_round + rpd)],
        "rounds": rounds,
        "depth": depth,
        "rounds_per_dispatch": rpd,
        "failures": failures,
        "fault": kind,
        "error": fault_attribution(exc)["error"],
        "resume": newest[0] if newest is not None else None,
        "hint": ("re-run pipeline_sweep(resume=<resume>, rounds_per_dispatch=1, depth=1) "
                 "to replay the window dispatch-by-dispatch"),
    }
    if checkpoint_path is not None:
        target = os.path.join(os.path.dirname(checkpoint_path) or ".",
                              f"poison_{fail_round}.json")
        try:
            with open(target, "w") as fh:
                json.dump(reproducer, fh, indent=2)
            reproducer["reproducer_path"] = target
        except OSError:
            pass
    obs.instant("poison_quarantine", round=fail_round, failures=failures)
    _metrics.emit({"event": "recovery", "v": _metrics.SCHEMA_VERSION, "fault": kind,
                   "action": "quarantine", "attempt": failures, "from_round": fail_round,
                   "lost_rounds": 0, "error": reproducer["error"]})
    obs.trace.flush_export()
    raise PoisonousWindow(
        f"campaign window starting at round {fail_round} failed {failures} time(s) — "
        f"quarantined; minimal reproducer: {json.dumps(reproducer, sort_keys=True)}",
        reproducer,
    ) from exc
