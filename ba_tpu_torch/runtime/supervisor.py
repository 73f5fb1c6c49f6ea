"""The execution supervisor's fault taxonomy (``ba_tpu/runtime/supervisor.py``):
how a raised execution error is classified, attributed and retried.

- :func:`classify_fault`: ``transient`` (retry in place), ``fatal`` or
  ``oom``.  An error's ``ba_tpu_fault`` attribute wins (chaos-injected
  faults carry one); then ``torch.cuda.OutOfMemoryError`` (or its
  message, "CUDA out of memory") is OOM; then the transient message
  markers; anything else is fatal, the safe default.
- :func:`fault_attribution`: ``{"fault", "error"}``, the one spelling
  the serving tier's request records use.
- :func:`backoff_s`: exponential backoff with jitter from sha256 of
  (seed, token, attempt): no global random state, the same delays as the
  JAX package's for the same triple.
- :func:`derive_timeout_s`: a watchdog timeout from the engine's own
  ``pipeline_dispatch_latency_s`` histogram.

The JAX package's ``BA_TPU_MAX_RETRIES`` and
``BA_TPU_SUPERVISE_TIMEOUT_S`` variables are :class:`SupervisorConfig`'s
``max_retries`` (default 3) and ``timeout_s`` fields.  The supervised
campaign loop itself (``supervised_sweep``), with its recovery,
degradation and poison budgets, is not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ba_tpu_torch import obs

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
    None to derive it."""

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    jitter_frac: float = 0.25
    seed: int = 0
    timeout_s: float | None = None
    timeout_multiplier: float = 16.0
    timeout_floor_s: float = 30.0

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
