"""Warm dispatch for the serving tier: the port's counterpart of the JAX
package's executable cache (``ba_tpu/obs/aotcache.py:196 ExecutableCache``).

The reference warms a cohort bucket by compiling its XLA executable ahead
of time.  On the card the work that warming takes off the request path
is the kernel libraries' build and load (``ops/_build.py``), and what
makes a warm dispatch cheaper than a cold one is a CUDA graph: one
``graph.replay()`` in place of the wrapper's checks, allocations and
ctypes launch.  :class:`GraphCache` keeps one entry a ``(fn, axes)``
signature, with the same ``get`` / ``ensure`` / ``evict`` as the
reference's cache and the warmup lattice's axes
(``runtime/warmup.py``):

- for ``coalesced_megastep`` cohorts on ``engine="cuda"`` (oral OM(1),
  plain or scenario), a :class:`SlotGraph`: one K1 slot-mode dispatch
  (``ops/scenario_step.py::cuda_coalesced_megastep``) captured at the
  bucket's (batch, capacity, window) shapes.  Its inputs and outputs
  live in static buffers: a replay copies the carry, keys, counter
  blocks and event planes in (a buffer that already holds them, the
  previous replay's carry, is not copied), and returns the static
  outputs.  The pipelined loop queues their pinned copies to the host
  right after the replay, on the same stream, so the next replay may
  overwrite them; the last round's majorities are read before the loop
  returns;
- for every other cohort kind (``engine="torch"``, m >= 2, signed) an
  :class:`EagerEntry`: the kernel libraries built and one eager dispatch
  run at the bucket's capacity and window (one a signature without its
  batch axis: the torch engine compiles nothing a shape), ``graph``
  False.  The EIG engine and the
  signed megastep read values back to the host inside a dispatch, which
  a graph cannot hold.

Capture runs on the warmup thread while the dispatcher may be launching:
it is made on a stream of its own with ``capture_error_mode=
"thread_local"``, which leaves other threads' allocations and waits
alone.  A graph is local to one process, so nothing is kept on disk: the
kernel build directory is the persistent part, and the reference's
``aot_cache`` directory has no counterpart (``ServeConfig(aot_cache=)``
raises).
"""

from __future__ import annotations

import threading
import time

COALESCED_FN = "coalesced_megastep"


def _freeze(axes: dict) -> tuple:
    return tuple(sorted(axes.items()))


class EagerEntry:
    """A signature made warm without a graph: its dispatch runs the
    engine's own call."""

    graph = False


class SlotGraph:
    """One K1 slot-mode dispatch captured as a CUDA graph at ``axes``'s
    shapes, on ``device``."""

    graph = True

    def __init__(self, axes: dict, device):
        import torch

        from ba_tpu_torch.ops import scenario_step

        B, n, R = axes["batch"], axes["capacity"], axes["rounds"]
        self.scenario = bool(axes["scenario"])
        dev = torch.device(device)
        self.state, self.sched, self.strategy, self.counters, self.events = _static_inputs(
            B, n, R, self.scenario, dev)
        kernel = scenario_step.cuda_coalesced_megastep
        kw = dict(rounds=R, scenario=self.scenario)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # one eager launch (counted by the wrapper): the library built
            # and its module loaded before the capture, which must launch
            # nothing for the first time and which the wrapper does not count
            kernel(self.state, self.sched, self.strategy, self.counters, self.events, **kw)
            self.graph_obj = torch.cuda.CUDAGraph()
            self.graph_obj.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = kernel(self.state, self.sched, self.strategy, self.counters,
                                  self.events, **kw)
            finally:
                self.graph_obj.capture_end()
        stream.synchronize()
        self._kernel_module = scenario_step

    def __call__(self, state, sched, strategy, counters, events, **_kw):
        """Copy the dispatch's inputs into the static buffers, replay, and
        return the static outputs ``(state, sched, strategy,
        last_majorities, decisions, counter_rows[, leaders])``."""
        _copy_in(self.state.tensors(), state.tensors())
        _copy_in((self.sched.key_data, self.sched.counter), (sched.key_data, sched.counter))
        _copy_in((self.counters,), (counters,))
        if self.scenario:
            _copy_in((self.strategy,), (strategy,))
            _copy_in(tuple(self.events[k] for k in sorted(self.events)),
                     tuple(events[k] for k in sorted(self.events)))
        self.graph_obj.replay()
        self._kernel_module.count_graph_replay()
        return self.out


def _copy_in(static, given) -> None:
    for s, g in zip(static, given):
        if s.data_ptr() != g.data_ptr():
            s.copy_(g)


def _static_inputs(B: int, n: int, R: int, scenario: bool, dev):
    """Valid carry and planes at a bucket's shapes: every general alive,
    ids 1..n, leader 0, no events."""
    import torch

    from ba_tpu_torch.core.state import SimState
    from ba_tpu_torch.parallel import pipeline

    state = SimState(
        order=torch.ones(B, dtype=torch.int8, device=dev),
        leader=torch.zeros(B, dtype=torch.int32, device=dev),
        faulty=torch.zeros((B, n), dtype=torch.bool, device=dev),
        alive=torch.ones((B, n), dtype=torch.bool, device=dev),
        ids=torch.arange(1, n + 1, dtype=torch.int32, device=dev).repeat(B, 1),
    )
    sched = pipeline.KeySchedule(torch.zeros((B, 2), dtype=torch.int64, device=dev),
                                 torch.zeros((), dtype=torch.int32, device=dev))
    C = len(pipeline.SCENARIO_COUNTER_NAMES if scenario else pipeline.COUNTER_NAMES)
    counters = torch.zeros((B, C), dtype=torch.int32, device=dev)
    strategy = events = None
    if scenario:
        strategy = torch.zeros((B, n), dtype=torch.int8, device=dev)
        events = {name: torch.zeros((R, B, n), dtype=pipeline._PLANE_DTYPES[name], device=dev)
                  for name in pipeline.EVENT_PLANES}
    return state, sched, strategy, counters, events


def build_entry(fn: str, axes: dict, device):
    """Make ``(fn, axes)`` warm on ``device``: a :class:`SlotGraph` for a
    K1 cohort, else an :class:`EagerEntry` after one eager dispatch."""
    import torch

    if fn != COALESCED_FN:
        raise ValueError(f"no warm entry for fn {fn!r} (know {COALESCED_FN!r})")
    dev = torch.device(device)
    if axes["engine"] == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"engine='cuda' warms on a CUDA device, not {dev}")
        return SlotGraph(axes, dev)
    _eager_dispatch(axes, dev)
    return EagerEntry()


def _eager_dispatch(axes: dict, dev) -> None:
    """One dispatch of the torch engine's cohort megastep at ``axes``'s
    capacity and window, one slot: the kernels it launches on the card
    (K9 at m >= 2) built and loaded.  The torch engine compiles nothing a
    shape, so the batch bucket adds nothing to warm, and a slot keeps the
    warmup of m = 2 at capacity 1024 small."""
    import torch

    from ba_tpu_torch.parallel import pipeline

    B, n, R = 1, axes["capacity"], axes["rounds"]
    scenario, signed = bool(axes["scenario"]), bool(axes["signed"])
    state, sched, strategy, counters, events = _static_inputs(B, n, R, scenario, dev)
    if signed:
        counters = torch.zeros((B, len(pipeline.SIGNED_COUNTER_NAMES)), dtype=torch.int32,
                               device=dev)
        verdicts = torch.ones((R, B, 2), dtype=torch.bool, device=dev)
        pipeline.coalesced_signed_megastep(state, sched, counters, verdicts, rounds=R,
                                           m=axes["m"], collapsed=bool(axes["collapsed"]))
    else:
        pipeline.coalesced_megastep(state, sched, strategy, counters, events, rounds=R,
                                    m=axes["m"], max_liars=axes["max_liars"],
                                    scenario=scenario)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class GraphCache:
    """Thread-safe ``(fn, axes)`` -> warm entry map on one device.

    - :meth:`get`: the dispatcher's lookup before each dispatch; never
      builds or captures (a miss returns None and the dispatch runs
      eagerly, as without a cache).
    - :meth:`ensure`: the warmup path; builds the entry (a capture, or
      an eager dispatch) unless it is there, and notes the signature in
      the compile ledger when one is configured (``obs/instrument.py``).
    - :meth:`evict`: drop an entry whose replay failed; later lookups
      miss.
    """

    def __init__(self, device=None):
        self.device = device
        self._lock = threading.Lock()
        self._mem: dict = {}
        self._eager_warm: set = set()  # signatures without the batch axis, dispatched once
        self.counts = {"captures": 0, "eager": 0, "hits": 0, "misses": 0, "evicted": 0}

    def __len__(self) -> int:
        return len(self._mem)

    def get(self, fn: str, axes: dict):
        key = (fn, _freeze(axes))
        with self._lock:
            entry = self._mem.get(key)
            self.counts["hits" if entry is not None else "misses"] += 1
            return entry

    def put(self, fn: str, axes: dict, entry) -> None:
        with self._lock:
            self._mem[(fn, _freeze(axes))] = entry

    def evict(self, fn: str, axes: dict) -> None:
        with self._lock:
            if self._mem.pop((fn, _freeze(axes)), None) is not None:
                self.counts["evicted"] += 1

    def ensure(self, fn: str, axes: dict, builder=None) -> dict:
        """Make ``(fn, axes)`` warm.  ``builder(axes)`` returns the entry
        (default :func:`build_entry` on the cache's device).  Returns
        ``{"status": "cached" | "captured" | "eager", "wall_s", "graph"}``;
        a builder's exception propagates (the warmup runner counts it)."""
        key = (fn, _freeze(axes))
        with self._lock:
            entry = self._mem.get(key)
        if entry is not None:
            return {"status": "cached", "wall_s": 0.0, "graph": entry.graph}
        t0 = time.perf_counter()
        unbatched = _freeze({k: v for k, v in axes.items() if k != "batch"})
        if axes.get("engine") != "cuda" and (fn, unbatched) in self._eager_warm:
            entry = EagerEntry()
        else:
            entry = builder(axes) if builder is not None else build_entry(fn, axes, self.device)
            if not entry.graph:
                self._eager_warm.add((fn, unbatched))
        with self._lock:
            self._mem[key] = entry
            self.counts["captures" if entry.graph else "eager"] += 1
        from ba_tpu_torch.obs import instrument

        instrument.note_ledger(fn, axes)  # the next process's warmup replays it
        return {"status": "captured" if entry.graph else "eager",
                "wall_s": round(time.perf_counter() - t0, 6), "graph": entry.graph}

    def graphs(self) -> int:
        """The captured graphs held."""
        with self._lock:
            return sum(1 for e in self._mem.values() if e.graph)
