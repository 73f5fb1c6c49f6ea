"""Compile-or-dispatch classification, the recompile explainer and the
cross-run compile ledger (``ba_tpu/obs/instrument.py``).

**A compile in the port** is the first dispatch of an ``(fn, axes)``
signature in the process, the reference's classification keyed on the
caller's named signature (shapes, capacity, rounds, m, engine...).  The
torch engine compiles nothing and K1 is one library for every shape, so
what such a first dispatch may really pay is a kernel library built or
loaded for the first time (``ops/_build.thread_loads`` rising); the
``compile`` span records that as ``library_load``.  The serving tier's
"compile on the request path" keeps that narrower meaning
(``pipeline.coalesced_sweep``'s ``request_path_compiles``).

- :func:`first_call` — True once a hashable key a process.
- :func:`classify_compile` — ``(first, changed, cross_process)`` for a
  named signature.  ``changed`` explains a re-specialisation: against
  the fn's previous signature in the process, or, with the ledger on, a
  first compile of the session that matches none of the previous
  processes' signatures, diffed against the closest of them.
- :func:`compile_or_dispatch_span` — a ``compile`` or ``dispatch`` span
  around a dispatch; a compile records its wall in ``compile_time_s``
  and an explained one emits a ``recompile`` record (and instant) naming
  the axes that changed (``recompiles_total``).

**The ledger** (:func:`configure_compile_ledger`) is a JSON file of every
fn's compile signatures, each with the process's toolchain axes
(:func:`toolchain_axes`: the torch version, ``torch.version.cuda``, the
``nvcc`` release when the toolkit is there, ``"package":
"ba_tpu_torch"``), merged with the rows on disk at every write, so
processes sharing one file keep each other's rows.  It is off unless a
caller configures it (``configure_compile_ledger(path)`` or
``ServeConfig(compile_ledger=path)``), the counterpart of the reference's
ledger beside its persistent XLA cache; :func:`default_ledger_path`
suggests a file beside the kernel build directory.  The serving warmup
replays it (``runtime/warmup.ledger_replay_set``).  Importing this module
imports no torch.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

from ba_tpu_torch.obs import registry as _registry
from ba_tpu_torch.obs import trace as _trace
from ba_tpu_torch.utils import metrics as _metrics

_seen: set = set()
_seen_lock = threading.Lock()
_last_axes: dict = {}  # fn -> the axes of its most recent compile

# The ledger: _ledger_prev holds the previous processes' signature lists
# a fn (read once at configure), _ledger_cur this process's; the file
# always holds their merge with what is on disk.
_ledger_lock = threading.Lock()
_ledger_path: str | None = None
_ledger_env: dict = {}
_ledger_prev: dict = {}
_ledger_cur: dict = {}
LEDGER_NAME = "ba_tpu_torch_axes_ledger.json"


def first_call(key) -> bool:
    """True exactly once a hashable ``key`` a process."""
    with _seen_lock:
        if key in _seen:
            return False
        _seen.add(key)
        return True


def _freeze(value):
    """A hashable, order-stable form of an axes value."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


@functools.lru_cache(maxsize=1)
def _nvcc_release():
    from ba_tpu_torch.ops import _build

    return _build.nvcc_release()


def toolchain_axes() -> dict:
    """This process's toolchain as ledger axes: ``package``, ``torch``,
    ``cuda`` (``torch.version.cuda``, None on a CPU build) and, where the
    CUDA toolkit is installed, ``nvcc`` (its release, e.g. ``"12.8"``)."""
    import torch

    axes = {"package": "ba_tpu_torch", "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if _nvcc_release() is not None:
        axes["nvcc"] = _nvcc_release()
    return axes


def default_ledger_path() -> str:
    """A suggested ledger file: beside the kernel build directory
    (``ops/_build/``), the port's persistent compile state."""
    from ba_tpu_torch.ops import _build

    return str(_build.BUILD_DIR / LEDGER_NAME)


def configure_compile_ledger(path: str | None, env_axes: dict | None = None):
    """Point the ledger at ``path`` (None turns it off).

    Reads the previous processes' signatures from ``path`` (an
    unreadable or corrupt file starts fresh: the ledger is forensics and
    a warmup hint, never a correctness dependency).  ``env_axes`` are
    merged into every stored signature (default :func:`toolchain_axes`),
    so a toolchain change shows up as the changed axis."""
    global _ledger_path, _ledger_env, _ledger_prev, _ledger_cur
    env = dict(toolchain_axes() if env_axes is None and path else env_axes or {})
    with _ledger_lock:
        _ledger_path = path or None
        _ledger_env = env
        _ledger_prev, _ledger_cur = {}, {}
        if path:
            _ledger_prev = _read_ledger_file(path)


def ledger_path() -> str | None:
    """The configured ledger file, or None."""
    return _ledger_path


def _read_ledger_file(path: str) -> dict:
    """``{fn: [signature, ...]}`` from a ledger file; unreadable, corrupt
    or wrong-version files read as empty."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("v") == 1 and isinstance(doc.get("fns"), dict):
            return {fn: sigs for fn, sigs in doc["fns"].items()
                    if isinstance(sigs, list) and all(isinstance(s, dict) for s in sigs)}
    except (OSError, ValueError, AttributeError):
        pass
    return {}


def ledger_signatures() -> dict:
    """``{fn: [signature, ...]}``: the previous processes' rows and this
    session's, each with its env axes (and ``run_id`` rider).  Empty when
    no ledger is configured."""
    with _ledger_lock:
        if _ledger_path is None:
            return {}
        fns = {f: [dict(s) for s in sigs] for f, sigs in _ledger_prev.items()}
        for f, cur in _ledger_cur.items():
            rows = fns.setdefault(f, [])
            rows.extend(dict(s) for s in cur if not _sig_in(s, rows))
        return fns


def ledger_env_axes() -> dict:
    """The configured env axes: what a row must carry to be reproducible
    by this process's toolchain (the warmup's replay filter)."""
    with _ledger_lock:
        return dict(_ledger_env)


def note_ledger(fn: str, axes: dict) -> None:
    """Store one signature in the ledger without marking it seen by the
    classifier: the warmup's entries (``obs/graphcache.py``) are recorded
    so the next process replays them, while the first real dispatch of
    the signature still classifies as it would.  No-op without a
    ledger."""
    with _ledger_lock:
        if _ledger_path is None:
            return
        _ledger_store_locked(fn, {**axes, **_ledger_env})


def _sig_core(sig: dict) -> dict:
    """A row without its ``run_id`` rider: the comparable signature."""
    return {k: v for k, v in sig.items() if k != "run_id"}


def _sig_in(sig: dict, rows) -> bool:
    core = _sig_core(sig)
    return any(_sig_core(r) == core for r in rows)


def _ledger_store_locked(fn: str, signature: dict) -> None:
    """Append ``signature`` to the fn's session rows and write the file
    through (an atomic replace): the previous processes' rows, the rows
    on disk now (another process's writes since this one configured) and
    this session's, in first-compile order.  The caller holds
    ``_ledger_lock``.  An unwritable file turns the ledger off."""
    global _ledger_path
    row = dict(signature)
    rid = _metrics.active_run_id()
    if rid is not None:
        row["run_id"] = rid  # provenance, never identity (_sig_core)
    sigs = _ledger_cur.setdefault(fn, [])
    if not _sig_in(row, sigs):
        sigs.append(row)
    fns = {f: list(s) for f, s in _ledger_prev.items()}
    for source in (_read_ledger_file(_ledger_path), _ledger_cur):
        for f, rows in source.items():
            merged = fns.setdefault(f, [])
            merged.extend(s for s in rows if not _sig_in(s, merged))
    tmp = f"{_ledger_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(_ledger_path)), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump({"v": 1, "fns": fns}, fh)
        os.replace(tmp, _ledger_path)
    except OSError:
        _ledger_path = None
        try:
            os.remove(tmp)
        except OSError:
            pass


def classify_compile(fn: str, axes: dict):
    """``(first_call, changed, cross_process)`` for one named signature:
    ``first_call`` True once a ``(fn, axes)``; ``changed`` a ``{axis:
    [previous, new]}`` diff on an explained compile (an in-process
    re-specialisation, or with the ledger a session-first signature that
    none of the previous processes' rows of the fn match, diffed against
    the closest of them; ``cross_process`` True then), else None."""
    key = (fn, _freeze(axes))
    with _seen_lock:
        if key in _seen:
            return False, None, False
        _seen.add(key)
        prev = _last_axes.get(fn)
        _last_axes[fn] = dict(axes)
    with _ledger_lock:
        ledgered = _ledger_path is not None
        prior = _ledger_prev.get(fn) if ledgered else None
        if ledgered:
            signature = {**axes, **_ledger_env}
            _ledger_store_locked(fn, signature)
    if prev is None:
        if ledgered and prior and not _sig_in(signature, prior):
            def diff_against(baseline):
                return {k: [baseline.get(k), signature.get(k)]
                        for k in {*baseline, *signature} if baseline.get(k) != signature.get(k)}

            # the closest prior row (fewest changed axes, the newest on a tie)
            changed = min((diff_against(_sig_core(b)) for b in reversed(prior)), key=len)
            if changed:
                return True, changed, True
        return True, None, False
    changed = {k: [prev.get(k), axes[k]] for k in axes if prev.get(k) != axes.get(k)}
    return True, changed or None, False


def reset_first_calls() -> None:
    """Forget every seen key and signature."""
    with _seen_lock:
        _seen.clear()
        _last_axes.clear()


class compile_or_dispatch_span:
    """A ``compile`` (first dispatch of the signature) or ``dispatch``
    span around a dispatch; ``with`` yields the phase name.

    ``axes`` (a dict) names the signature and opts into the recompile
    explainer, keyed on ``key`` (its first element when a tuple) and the
    axes; without it ``key`` itself is classified by :func:`first_call`.
    A compile records its host wall in ``compile_time_s``, and its span
    carries ``library_load``: whether this thread built or first loaded a
    kernel library during it.  A class, not a generator: the dispatch
    loops open one a dispatch."""

    __slots__ = ("_key", "_axes", "_attrs", "phase", "_fn", "_changed", "_cross", "_span",
                 "_span_attrs", "_t0", "_loads")

    def __init__(self, key, axes=None, **attrs):
        self._key, self._axes, self._attrs = key, axes, attrs

    def __enter__(self):
        if self._axes is None:
            first, self._changed, self._cross, self._fn = first_call(self._key), None, False, None
        else:
            key = self._key
            self._fn = key[0] if isinstance(key, tuple) and key else str(key)
            first, self._changed, self._cross = classify_compile(self._fn, self._axes)
        self.phase = "compile" if first else "dispatch"
        self._loads = None
        if first:
            from ba_tpu_torch.ops import _build

            self._loads = _build.thread_loads()
        self._span = _trace.default_tracer().span(self.phase, **self._attrs)
        self._span_attrs = self._span.__enter__()
        self._t0 = time.perf_counter()
        return self.phase

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        if self._loads is not None:
            from ba_tpu_torch.ops import _build

            if self._span_attrs is not None:
                self._span_attrs["library_load"] = _build.thread_loads() != self._loads
        self._span.__exit__(*exc)
        if self.phase == "compile":
            _registry.default_registry().histogram("compile_time_s").record(elapsed)
            if self._changed:
                _emit_recompile(self._fn, self._axes, self._changed, self._cross)
        return False


def _emit_recompile(fn: str, axes: dict, changed: dict, cross_process: bool = False) -> None:
    """One ``recompile`` instant and record naming the axes whose change
    forced the new signature (``cross_process``: explained by the
    ledger, against a previous process)."""
    _registry.default_registry().counter("recompiles_total").inc()
    _trace.default_tracer().instant("recompile", fn=fn, changed=",".join(sorted(changed)),
                                    cross_process=cross_process)
    _metrics.emit({"event": "recompile", "v": _metrics.SCHEMA_VERSION, "fn": fn,
                   "changed": changed, "axes": dict(axes), "cross_process": cross_process})


def report_compile_cache(path: str | None) -> None:
    """Record where the port keeps its compiled state: the
    ``compile_cache_enabled`` gauge (0 / 1) and, with a directory (the
    kernel build directory, ``ops/_build.BUILD_DIR``), an instant that
    names it."""
    _registry.default_registry().gauge("compile_cache_enabled").set(0 if path is None else 1)
    if path is not None:
        _trace.default_tracer().instant("compile_cache_enabled", dir=str(path))
