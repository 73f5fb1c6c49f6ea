"""Device-tier observability on the card: kernel artifact records, NVTX
annotations and profiler capture.  This module replaces the JAX
package's ``ba_tpu/obs/xla.py``.

- **Artifact records** (:func:`introspect`).  On the first (``compile``)
  dispatch of a ``"cuda"``-engine megastep signature, with the metrics
  sink live or a dump directory configured, the dispatch loop brackets
  the dispatch with a probe and emits one ``{"event":
  "compiled_artifact", "v": 1, ...}`` record with the reference's
  fields: ``fn`` and ``axes``; ``flops`` and ``bytes_accessed`` null (no
  compiler computes a cost analysis of a hand-written kernel);
  ``argument_bytes`` and ``output_bytes`` (the inputs' and the outputs'
  bytes); ``temp_bytes`` (the rise of ``torch.cuda.max_memory_allocated``
  over the dispatch, whose peak the probe resets first: the dispatch's
  fresh outputs included); ``alias_bytes``, the bytes of input tensors
  the dispatch updated in place (the same ``data_ptr`` among its
  outputs): the port's evidence for the in-place carry contract, with
  ``donation_aliased`` = ``alias_bytes > 0``; ``generated_code_bytes``,
  the kernel library's size; and, in place of the reference's HLO dump,
  ``kernels``: each kernel's registers, spill stores and loads, and
  shared and local bytes from the build's ``ptxas -v`` report
  (``ops/_build.library_record``).  The ``cuda_<fn>_*`` gauges and the
  ``cuda_introspect_s`` histogram follow.  A failed introspection warns
  once a fn on stderr and never raises into the agreement path.  Meshed
  and ``"torch"``-engine dispatches are not introspected.
- **Dumps** (``configure(dump_dir=)``, the reference's ``BA_TPU_HLO``):
  each record and its library's ``ptxas`` report written into the
  directory, one stable name a signature.
- **Annotations** (:func:`annotate`): while a profiler session is active
  (or ``configure(profile_dir=)`` asks for them), an NVTX range and a
  ``torch.profiler`` user annotation around each megastep dispatch
  (``megastep_dispatch``, ``coalesced_dispatch``); otherwise a free
  ``nullcontext``.
- **Capture** (:func:`profile_session`, the reference's
  ``xprof_session``; its ``BA_TPU_XPROF`` is ``configure(profile_dir=)``):
  a ``torch.profiler.profile`` over CPU and CUDA activity that exports
  one Chrome trace into the directory.

Nothing here reads the environment, and importing the module imports no
torch: every torch import is inside a function that needs the card.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time

from ba_tpu_torch.obs import registry as _registry
from ba_tpu_torch.obs import trace as _trace
from ba_tpu_torch.utils import metrics as _metrics

_dump_dir: str | None = None
_profile_dir: str | None = None
_profiling = False
_warned_fns: set = set()
_UNSET = object()


def configure(dump_dir=_UNSET, profile_dir=_UNSET) -> None:
    """Set the artifact dump directory and the profile directory (None
    turns either off; an argument left out keeps its setting)."""
    global _dump_dir, _profile_dir
    if dump_dir is not _UNSET:
        _dump_dir = str(dump_dir) if dump_dir else None
    if profile_dir is not _UNSET:
        _profile_dir = str(profile_dir) if profile_dir else None


def enabled() -> bool:
    """Should a dispatch loop introspect: the metrics sink is live or a
    dump directory is set."""
    return _dump_dir is not None or _metrics.default_sink().enabled


def _tensors(tree):
    """The tensors of a tree of tuples, lists, dicts and dataclasses
    (``SimState``, ``KeySchedule``)."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _by_pointer(tree) -> dict:
    return {t.data_ptr(): t.nbytes for t in _tensors(tree) if t.nbytes}


def _warn(fn: str, exc) -> None:
    if fn not in _warned_fns:
        _warned_fns.add(fn)
        print(f"ba_tpu_torch.obs.cuda: introspection of {fn!r} failed ({exc!r}); skipping",
              file=sys.stderr)


class Probe:
    """One dispatch bracketed for its artifact record: made by
    :func:`introspect` before the dispatch, :meth:`emit` after it."""

    def __init__(self, fn, axes, args, sources, device):
        import torch

        self.fn, self.axes, self.sources = fn, dict(axes or {}), tuple(sources)
        self.device = torch.device(device)
        self.inputs = _by_pointer(args)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.peak_before = torch.cuda.max_memory_allocated(self.device)

    def emit(self, outputs):
        """Emit the record for the dispatch that returned ``outputs``;
        returns it (None when the introspection failed)."""
        try:
            import torch

            from ba_tpu_torch.ops import _build

            with _trace.timed_span("cuda_introspect", _registry.default_registry().histogram(
                    "cuda_introspect_s"), fn=self.fn):
                temp = torch.cuda.max_memory_allocated(self.device) - self.peak_before
                outs = _by_pointer(outputs)
                libs = [_build.library_record(src) for src in self.sources]
                kernels = {name: res for lib in libs for name, res in lib["kernels"].items()}
                alias = sum(nb for ptr, nb in self.inputs.items() if ptr in outs)
                record = {
                    "event": "compiled_artifact", "v": _metrics.SCHEMA_VERSION,
                    "fn": self.fn, "axes": self.axes, "flops": None, "bytes_accessed": None,
                    "argument_bytes": sum(self.inputs.values()),
                    "output_bytes": sum(outs.values()),
                    "temp_bytes": int(temp), "alias_bytes": alias,
                    "generated_code_bytes": sum(lib["bytes"] for lib in libs),
                    "donation_aliased": alias > 0,
                    "libraries": list(self.sources), "kernels": kernels,
                }
                record["dump"] = _dump(self.fn, self.axes, record, libs)
        except Exception as exc:  # never into the agreement path
            _warn(self.fn, exc)
            return None
        _metrics.emit(record)
        reg = _registry.default_registry()
        for field in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"):
            reg.gauge(f"cuda_{self.fn}_{field}").set(record[field])
        _trace.instant("compiled_artifact", fn=self.fn, alias_bytes=record["alias_bytes"],
                       temp_bytes=record["temp_bytes"])
        return record


def introspect(fn: str, axes: dict, args, *, sources, device):
    """A :class:`Probe` of the dispatch about to run (``args``: its input
    tensors, any nesting; ``sources``: the ``ops/csrc`` files whose
    libraries it launches), or None when :func:`enabled` is False or the
    probe cannot be made (warned once a fn)."""
    if not enabled():
        return None
    try:
        return Probe(fn, axes, args, sources, device)
    except Exception as exc:
        _warn(fn, exc)
        return None


def _dump(fn: str, axes: dict, record: dict, libs) -> str | None:
    """Write the record and its libraries' ``ptxas`` reports under the
    dump directory (one stable name a signature); the path stem, or
    None with no directory."""
    if _dump_dir is None:
        return None
    tag = hashlib.sha256(json.dumps(axes, sort_keys=True, default=str).encode()).hexdigest()[:10]
    os.makedirs(_dump_dir, exist_ok=True)
    stem = os.path.join(_dump_dir, f"{fn}-{tag}")
    with open(stem + ".json", "w") as fh:
        json.dump({**record, "dump": stem}, fh, indent=1, sort_keys=True)
    reports = []
    for lib in libs:
        log = lib["path"] + ".ptxas.txt"
        if os.path.exists(log):
            with open(log) as fh:
                reports.append(fh.read())
    with open(stem + ".ptxas.txt", "w") as fh:
        fh.write("".join(reports))
    return stem


# -- profiler capture ----------------------------------------------------------


def profiling() -> bool:
    """A capture session is running, or ``configure(profile_dir=)`` asks
    for annotations."""
    return _profiling or _profile_dir is not None


class _Annotation:
    """An NVTX range (on a CUDA build with a card) and a profiler user
    annotation around a block."""

    __slots__ = ("_name", "_fn", "_nvtx")

    def __init__(self, name: str):
        self._name = name
        self._fn = None
        self._nvtx = False

    def __enter__(self):
        import torch

        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._fn = torch.autograd.profiler.record_function(self._name)
        self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self._fn.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


_NULL = contextlib.nullcontext()


def annotate(name: str, **attrs):
    """An NVTX range named ``name`` (and a ``torch.profiler`` user
    annotation) while profiling, else a free ``nullcontext``.  ``attrs``
    are for the host trace's spelling and are not recorded here."""
    if not profiling():
        return _NULL
    return _Annotation(name)


class ProfileSession:
    """What :func:`profile_session` yields: ``directory``, and after the
    block ``path`` (the exported Chrome trace), ``block_s`` (the block's
    own wall) and ``wall_s`` (with the profiler's start and stop)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = None
        self.block_s = None
        self.wall_s = None


@contextlib.contextmanager
def profile_session(directory: str | None = None):
    """Capture a ``torch.profiler`` trace of the block (CPU and CUDA
    activity) into ``directory`` (default the configured profile
    directory) as one Chrome trace file, ``trace-<pid>-<n>.json``."""
    global _profiling
    import torch

    directory = directory or _profile_dir
    if not directory:
        raise ValueError("profile_session needs a directory (or configure(profile_dir=))")
    os.makedirs(directory, exist_ok=True)
    session = ProfileSession(directory)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    n = len([f for f in os.listdir(directory) if f.startswith(f"trace-{os.getpid()}-")])
    t0 = time.perf_counter()
    prof.__enter__()
    _profiling = True
    t_block = time.perf_counter()
    try:
        yield session
    finally:
        session.block_s = time.perf_counter() - t_block
        _profiling = False
        prof.__exit__(None, None, None)
        session.wall_s = time.perf_counter() - t0
        session.path = os.path.join(directory, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(session.path)
