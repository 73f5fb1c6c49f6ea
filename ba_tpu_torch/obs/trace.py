"""Host span tracing and trace contexts (``ba_tpu/obs/trace.py``).

:class:`Tracer` keeps closed host spans in a fixed-capacity ring buffer
(``time.perf_counter_ns`` clocks) and exports them as Chrome trace
events (Perfetto, ``chrome://tracing``).  Off by default: a span is then
one attribute check, and the buffer never grows.  The JAX package's
``BA_TPU_TRACE`` variable is :func:`configure` here: ``configure(True)``
buffers, ``configure(path)`` buffers and exports to ``path`` at exit
(or at :func:`flush_export`), ``configure(None)`` turns it off.  Spans
wrap host phases only, never anything a kernel runs.

:func:`timed_span` is one clock window read both as a span and as a
latency (a histogram's sample, or the yielded box's ``elapsed_s``).

The trace context is the tuple ``(trace_id, span_id, parent_id)``: the
sink (``utils/metrics.py``) stamps it onto every record emitted inside a
:func:`scope`.  Contexts are per thread and never inherited: every hop is
an explicit :func:`child_context` and :func:`scope`.  The JAX package's
``BA_TPU_TRACE_CONTEXT`` variable is a ``traceparent`` keyword here: a
serving request's, or a campaign's (``pipeline_sweep(traceparent=)``,
``supervised_sweep(traceparent=)``), which :func:`inject_scope` adopts.
Stdlib only.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import sys
import threading
import time

from ba_tpu_torch.utils import metrics as _metrics

_INSTANT = -1  # a record's duration for an instant event


class Tracer:
    """Fixed-capacity ring buffer of host spans: ``(name, start ns,
    duration ns, thread id, attrs)``; the oldest drop first."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """One closed span around the body (thread-safe; spans inside a
        run scope carry its ``run_id``).  ``with`` yields the span's
        attribute dict, which the body may add to (None when the tracer
        is off)."""
        if not self.enabled:
            yield None
            return
        rid = _metrics.active_run_id()
        if rid is not None:
            attrs.setdefault("run_id", rid)
        t0 = time.perf_counter_ns()
        try:
            yield attrs
        finally:
            dur = time.perf_counter_ns() - t0
            with self._lock:
                self._buf.append((name, t0, dur, threading.get_ident(), attrs or None))

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker."""
        if not self.enabled:
            return
        rid = _metrics.active_run_id()
        if rid is not None:
            attrs.setdefault("run_id", rid)
        with self._lock:
            self._buf.append((name, time.perf_counter_ns(), _INSTANT, threading.get_ident(),
                              attrs or None))

    def chrome_events(self) -> list[dict]:
        """The buffer as Chrome trace-event dicts (``ph`` ``X`` or ``i``,
        microseconds)."""
        with self._lock:
            records = list(self._buf)
        events = []
        for name, t0, dur, tid, attrs in records:
            ev = {"name": name, "ts": t0 / 1e3, "pid": self._pid, "tid": tid,
                  "args": attrs or {}}
            if dur == _INSTANT:
                ev["ph"], ev["s"] = "i", "t"
            else:
                ev["ph"], ev["dur"] = "X", dur / 1e3
            events.append(ev)
        return events

    def export_chrome(self, path: str) -> str:
        """Write the buffer as a Chrome trace-event JSON file."""
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}, fh)
        return path


_default: Tracer | None = None
_export_path: str | None = None
_atexit_registered = False


def default_tracer() -> Tracer:
    """The process-wide tracer (off until :func:`configure`)."""
    global _default
    if _default is None:
        _default = Tracer()
    return _default


def configure(target) -> Tracer:
    """Turn the default tracer on (``True`` or a path, which the buffer
    is exported to at exit) or off (``None`` / ``False``); the buffer is
    cleared."""
    global _export_path, _atexit_registered
    tracer = default_tracer()
    tracer.clear()
    tracer.enabled = bool(target)
    _export_path = target if isinstance(target, str) and target else None
    if _export_path is not None and not _atexit_registered:
        atexit.register(flush_export)
        _atexit_registered = True
    return tracer


def flush_export() -> str | None:
    """Export the default tracer's buffer to the configured path now
    (best effort; a later export overwrites with a superset).  Returns
    the path, or None when no path is configured."""
    path, tracer = _export_path, default_tracer()
    if path is None or not tracer.enabled:
        return None
    try:
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tracer.export_chrome(path)
    except OSError as e:
        print(f"ba_tpu_torch.obs: trace export to {path!r} failed: {e}", file=sys.stderr)
        return None
    return path


def span(name: str, **attrs):
    """``span`` on the default tracer."""
    return default_tracer().span(name, **attrs)


class timed_span:
    """One clock window feeding both a span of the default tracer and a
    latency: ``histogram`` (a registry ``Histogram``, or None) records it
    when the window closes, and the yielded box's ``elapsed_s`` holds it
    for callers that batch their records.  A class, not a generator: a
    dispatch loop opens one a retire."""

    __slots__ = ("_name", "_histogram", "_attrs", "_span", "_t0", "elapsed_s")

    def __init__(self, name: str, histogram=None, **attrs):
        self._name, self._histogram, self._attrs = name, histogram, attrs
        self._span = None
        self.elapsed_s = None

    def __enter__(self):
        tracer = default_tracer()
        if tracer.enabled:
            self._span = tracer.span(self._name, **self._attrs)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(*exc)
        if self._histogram is not None:
            self._histogram.record(self.elapsed_s)
        return False


def instant(name: str, **attrs) -> None:
    default_tracer().instant(name, **attrs)


# -- trace contexts ----------------------------------------------------------


def current() -> tuple | None:
    """The calling thread's ``(trace_id, span_id, parent_id)``, or None."""
    return _metrics.active_trace_context()


def current_traceparent() -> str | None:
    """The active context as a traceparent string, or None."""
    ctx = _metrics.active_trace_context()
    return None if ctx is None else _metrics.format_traceparent(ctx[0], ctx[1])


def new_context(parent=None) -> tuple:
    """A child of ``parent`` (a context tuple or a traceparent string; a
    malformed string degrades to a new root), else a new root."""
    if isinstance(parent, str):
        parsed = _metrics.parse_traceparent(parent)
        if parsed is None:
            parent = None
        else:
            return (parsed[0], _metrics.new_span_id(), parsed[1])
    if parent is None:
        return (_metrics.new_trace_id(), _metrics.new_span_id(), None)
    return (parent[0], _metrics.new_span_id(), parent[1])


def child_context(parent=None) -> tuple:
    """A child of ``parent`` (default: the thread's context; a new root
    when untraced)."""
    return new_context(parent if parent is not None else current())


@contextlib.contextmanager
def scope(ctx: tuple | None):
    """Make ``ctx`` the thread's context for the body (None passes
    through), restoring the previous one on exit."""
    if ctx is None:
        yield None
        return
    prev = _metrics.set_trace_context(ctx)
    try:
        yield ctx
    finally:
        _metrics.set_trace_context(prev)


@contextlib.contextmanager
def inject_scope(traceparent: str | None = None, mark: str | None = None):
    """A campaign's entry scope: keep the thread's active context when
    there is one, else adopt a child of ``traceparent`` (a caller's
    position, or a resumed campaign's checkpoint header), else stay
    untraced.  On adoption only, ``mark`` names a zero-duration
    ``trace_span`` record of the new position, written at once, so a
    campaign killed mid-flight still leaves the span its windows parent
    under."""
    if current() is not None:
        yield current()
        return
    if traceparent is None or _metrics.parse_traceparent(traceparent) is None:
        yield None
        return
    with scope(new_context(traceparent)) as ctx:
        if mark is not None:
            emit_trace_span(mark, ctx, time.perf_counter(), 0.0)
        yield ctx


def emit_trace_span(name: str, ctx: tuple, t0_perf: float, dur_s: float, **attrs) -> None:
    """One explicit span node in the JSON-lines stream, for a causal
    position no other record carries (a coalesced batch's fan-in)."""
    _metrics.emit({"event": "trace_span", "v": _metrics.SCHEMA_VERSION, "name": name,
                   "trace_id": ctx[0], "span_id": ctx[1], "parent_id": ctx[2],
                   "t_perf": round(t0_perf, 6), "dur_s": round(dur_s, 6), **attrs})
