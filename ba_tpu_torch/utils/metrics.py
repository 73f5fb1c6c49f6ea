"""The JSON-lines metrics sink (``ba_tpu/utils/metrics.py``): one
versioned record a line, the bottom of the observability stack.

Every record carries ``"v": SCHEMA_VERSION`` and a ``ts`` wall-clock
stamp (for correlation only: durations are measured with
``time.perf_counter`` where they are taken).  The JAX package's
``BA_TPU_METRICS`` variable is :func:`configure` here: ``configure(path)``
appends to a file, ``configure("-")`` writes to stderr, a path ending in
a separator (or an existing directory) writes one shard a process
(``<pid>.<token>.jsonl``, opened by a ``clock_anchor`` record), and
``configure(None)`` turns the sink off.  With no target the sink writes
nothing and holds nothing.

Emission is thread-safe (one write a record, under a lock).  A failing
target (``OSError``) warns once on stderr and turns the sink off: the
agreement path never fails for its telemetry.

The run id and the trace context live here too, so the sink can stamp
every record emitted inside a scope: the run id is one module global
(written by its scope's owner), the trace context ``(trace_id, span_id,
parent_id)`` is per thread and never inherited by another thread.
Stdlib only.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import sys
import threading
import time

SCHEMA_VERSION = 1

_run_id: str | None = None


def set_run_id(run_id: str | None) -> str | None:
    """Install ``run_id`` as the active run (None clears); returns the
    previous one so a scope can restore it."""
    global _run_id
    prev = _run_id
    _run_id = run_id
    return prev


def active_run_id() -> str | None:
    return _run_id


_trace_local = threading.local()


def set_trace_context(ctx: tuple | None) -> tuple | None:
    """Install ``(trace_id, span_id, parent_id)`` as the calling thread's
    context (None clears); returns the previous one.  ``obs.trace.scope``
    is the usual way in."""
    prev = getattr(_trace_local, "ctx", None)
    _trace_local.ctx = ctx
    return prev


def active_trace_context() -> tuple | None:
    return getattr(_trace_local, "ctx", None)


# W3C traceparent, version 00, the sampled flag always set.
_TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value) -> tuple | None:
    """``(trace_id, span_id)`` of a traceparent string, or None for
    anything malformed (external input degrades to untraced)."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None or m.group(1) == "0" * 32 or m.group(2) == "0" * 16:
        return None
    return (m.group(1), m.group(2))


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def is_dir_target(target) -> bool:
    """True when ``target`` selects one shard a process in a directory: a
    trailing separator, or an existing directory."""
    if not target or target == "-":
        return False
    return target.endswith(("/", os.sep)) or os.path.isdir(target)


_shard_token: str | None = None


def _process_shard_name() -> str:
    global _shard_token
    if _shard_token is None:
        _shard_token = _run_id or f"proc-{os.urandom(4).hex()}"
    return f"{os.getpid()}.{_shard_token}.jsonl"


class MetricsSink:
    """Append-mode JSON-lines emitter; a falsy ``target`` disables it.
    The file opens at the first record and stays open (flushed a line)."""

    def __init__(self, target: str | None = None):
        self.target = target
        self._fh = None
        self._lock = threading.Lock()
        self._atexit_registered = False
        self.shard_path: str | None = None

    @property
    def enabled(self) -> bool:
        return bool(self.target)

    def file_path(self) -> str | None:
        """The file this sink appends to (the shard of a directory target
        once opened); None for stderr or a disabled sink."""
        if not self.target or self.target == "-":
            return None
        if is_dir_target(self.target):
            return self.shard_path
        return self.target

    def emit(self, record: dict) -> None:
        if not self.target:
            return
        record.setdefault("v", SCHEMA_VERSION)
        record.setdefault("ts", round(time.time(), 3))
        if _run_id is not None:
            record.setdefault("run_id", _run_id)
        ctx = getattr(_trace_local, "ctx", None)
        if ctx is not None:
            record.setdefault("trace_id", ctx[0])
            record.setdefault("span_id", ctx[1])
            if ctx[2] is not None:
                record.setdefault("parent_id", ctx[2])
        line = json.dumps(record)
        with self._lock:
            if not self.target:
                return
            if self._fh is None and not self._open():
                return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except OSError as e:
                self._disable(e)

    def _open(self) -> bool:
        """Open the target (under ``_lock``); False when it failed."""
        if self.target == "-":
            self._fh = sys.stderr  # borrowed: close() leaves it open
            return True
        anchor = None
        try:
            path = self.target
            if is_dir_target(path):
                os.makedirs(path, exist_ok=True)
                shard = _process_shard_name()
                self.shard_path = path = os.path.join(path, shard)
                anchor = {"event": "clock_anchor", "v": SCHEMA_VERSION, "pid": os.getpid(),
                          "shard": shard, "perf_t": time.perf_counter(),
                          "ts": round(time.time(), 6)}
            elif os.path.dirname(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
            self._fh = open(path, "a")
            if anchor is not None:
                self._fh.write(json.dumps(anchor) + "\n")
        except OSError as e:
            self._disable(e)
            return False
        if not self._atexit_registered:
            atexit.register(self.close)
            self._atexit_registered = True
        return True

    def _owns_fh(self) -> bool:
        return self._fh is not None and self.target != "-"

    def _disable(self, err: OSError) -> None:
        """Warn once and turn the sink off (under ``_lock``)."""
        owned = self._owns_fh()
        target, self.target = self.target, None
        if self._fh is not None and owned:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        try:
            print(f"ba_tpu_torch.utils.metrics: sink {target!r} failed ({err}); "
                  f"metrics disabled", file=sys.stderr)
        except OSError:
            pass

    def close(self) -> None:
        """Close the held handle (idempotent; the next record reopens)."""
        with self._lock:
            if self._owns_fh():
                try:
                    self._fh.close()
                except OSError:
                    pass
            self._fh = None


_default: MetricsSink | None = None


def default_sink() -> MetricsSink:
    """The process-wide sink: off until :func:`configure` names a target."""
    global _default
    if _default is None:
        _default = MetricsSink()
    return _default


def configure(target: str | None) -> MetricsSink:
    """Point the process-wide sink at ``target`` (closing the old handle)."""
    global _default
    if _default is not None:
        _default.close()
    _default = MetricsSink(target)
    return _default


def emit(record: dict) -> None:
    default_sink().emit(record)
