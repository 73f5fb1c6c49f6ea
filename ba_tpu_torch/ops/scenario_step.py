"""Wrappers of K1, the megastep kernel for Hopper (``csrc/megastep.cu``).

K1 replaces ``ba_tpu/ops/scenario_step.py::_megastep_kernel`` (the
Pallas TPU kernel, all three of its modes: plain, scenario and slot):
R whole OM(1) rounds per launch — events, lowest alive id re-election,
threefry coins, the strategy lie table, the tallies, the 3f+1 quorum
and the counter fold.  What bounds it on the
H100 is integer operations (threefry words for the coins of faulty
responders; the source's header works this out and says what the
design does about it).

:func:`cuda_pipeline_megastep`, :func:`cuda_scenario_megastep` and
:func:`cuda_coalesced_megastep` take the arguments and return the tuples
of ``parallel/pipeline.py``'s ``pipeline_megastep``, ``scenario_megastep``
and ``coalesced_megastep``, and update the carry in place the same way.
The last is the slot mode: a serving cohort of independent slots, one
base key and one counter block a slot, each slot folding instance index
0, and the last round's majorities of every general.  On a CUDA tensor they launch the kernel or
raise; on a CPU tensor they run the plain version.  Each keeps a plain
integer ``launches`` count, raised by one per kernel launch (a replay of
a CUDA graph that holds a slot-mode launch counts as one,
:func:`count_graph_replay`; the capture itself counts none).
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.ops import _build
from ba_tpu_torch.parallel import pipeline

SOURCE = "megastep.cu"
# Shared memory per block is 17 bytes a general (ba_megastep_smem_bytes);
# a Hopper block may use 227 KB.
MAX_N = 232448 // 17


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_megastep
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 20
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(state, sched, strategy, counters, events, *, rounds, collect_decisions,
            slot=False):
    """Check the carry, allocate the outputs, launch, advance the counter.
    Returns (histograms | None, leaders | None, decisions | None, rows |
    None, majorities | None): slot mode has no histograms and always
    returns decisions, per-slot rows and the last round's majorities."""
    B, n = state.faulty.shape
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"the megastep kernel runs on a CUDA device, not {dev}")
    if not rng.threefry_partitionable():
        raise ValueError("the megastep kernel follows the partitionable threefry mode only")
    if rounds < 1 or B < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"rounds={rounds}, B={B}, n={n} outside the kernel's range "
                         f"(rounds, B >= 1, 1 <= n <= {MAX_N})")
    _build.check_tensor(sched.key_data, "key_data", torch.int64, (B, 2) if slot else (2,), dev)
    _build.check_tensor(sched.counter, "counter", torch.int32, (), dev)
    _build.check_tensor(state.order, "order", torch.int8, (B,), dev)
    _build.check_tensor(state.leader, "leader", torch.int32, (B,), dev)
    for name, dtype in (("faulty", torch.bool), ("alive", torch.bool), ("ids", torch.int32)):
        _build.check_tensor(getattr(state, name), name, dtype, (B, n), dev)
    scenario = events is not None
    if scenario:
        _build.check_tensor(strategy, "strategy", torch.int8, (B, n), dev)
        for name, dtype in (("kill", torch.bool), ("revive", torch.bool),
                            ("set_faulty", torch.int8), ("set_strategy", torch.int8)):
            _build.check_tensor(events[name], name, dtype, (rounds, B, n), dev)
    C = 5 if scenario else 3
    n_counters = 0
    if counters is not None:
        counters = counters.contiguous()
        n_counters = C
        _build.check_tensor(counters, "counters", torch.int32, (B, C) if slot else (C,), dev)
    elif slot:
        raise ValueError("slot mode needs the [B, C] counter blocks")

    hist = verdicts = majorities = None
    if slot:
        majorities = torch.empty((B, n), dtype=torch.int8, device=dev)
        collect_decisions = True
    else:
        hist = torch.empty((rounds, 3), dtype=torch.int32, device=dev)
        verdicts = torch.empty((rounds, 3), dtype=torch.int32, device=dev)
    decisions = (
        torch.empty((rounds, B), dtype=torch.int8, device=dev) if collect_decisions else None
    )
    leaders = torch.empty((rounds, B), dtype=torch.int32, device=dev) if scenario else None
    rows = None
    if n_counters:
        rows = torch.empty((rounds, B, C) if slot else (rounds, C), dtype=torch.int32,
                           device=dev)
    ev = events or {}
    err = _lib().ba_megastep(
        B, n, rounds, n_counters, int(slot),
        _ptr(sched.key_data), _ptr(sched.counter), _ptr(state.order),
        _ptr(state.leader), _ptr(state.faulty), _ptr(state.alive), _ptr(state.ids),
        _ptr(strategy if scenario else None),
        _ptr(ev.get("kill")), _ptr(ev.get("revive")),
        _ptr(ev.get("set_faulty")), _ptr(ev.get("set_strategy")),
        _ptr(decisions), _ptr(leaders), _ptr(hist), _ptr(verdicts),
        _ptr(counters), _ptr(rows), _ptr(majorities),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"megastep launch failed: CUDA error {err}")
    sched.counter.add_(rounds)  # stream-ordered after the kernel's read
    return hist, leaders, decisions, rows, majorities


def cuda_pipeline_megastep(  # ba-lint: donates(state, sched)
    state, sched, *, rounds: int, m: int = 1, max_liars: int | None = None,
    collect_decisions: bool = False, counters=None,
):
    """K1 twin of ``pipeline_megastep``: returns ``(state, sched,
    histograms[, decisions][, counter_rows])``."""
    if state.device.type == "cpu":
        return pipeline.pipeline_megastep(
            state, sched, rounds=rounds, m=m, max_liars=max_liars,
            collect_decisions=collect_decisions, counters=counters,
        )
    if m != 1:
        raise ValueError(f"the megastep kernel runs OM(1) only (m == 1), got m={m}")
    hist, _, decisions, rows, _ = _launch(
        state, sched, None, counters, None,
        rounds=rounds, collect_decisions=collect_decisions,
    )
    cuda_pipeline_megastep.launches += 1
    out = (state, sched, hist)
    if collect_decisions:
        out += (decisions,)
    if counters is not None:
        out += (rows,)
    return out


def cuda_scenario_megastep(  # ba-lint: donates(state, sched, strategy)
    state, sched, strategy, counters, events, *, rounds: int, m: int = 1,
    max_liars: int | None = None, collect_decisions: bool = False,
):
    """K1 twin of ``scenario_megastep``: returns ``(state, sched,
    strategy, histograms, leaders, counter_rows[, decisions])``."""
    if state.device.type == "cpu":
        return pipeline.scenario_megastep(
            state, sched, strategy, counters, events, rounds=rounds, m=m,
            max_liars=max_liars, collect_decisions=collect_decisions,
        )
    if m != 1:
        raise ValueError(f"the megastep kernel runs OM(1) only (m == 1), got m={m}")
    hist, leaders, decisions, rows, _ = _launch(
        state, sched, strategy, counters, events,
        rounds=rounds, collect_decisions=collect_decisions,
    )
    cuda_scenario_megastep.launches += 1
    out = (state, sched, strategy, hist, leaders, rows)
    if collect_decisions:
        out += (decisions,)
    return out


def cuda_coalesced_megastep(  # ba-lint: donates(state, sched, strategy)
    state, sched, strategy, slot_counters, events, *, rounds: int, m: int = 1,
    max_liars: int | None = None, scenario: bool = False,
):
    """K1's slot mode, the twin of ``coalesced_megastep``: returns
    ``(state, sched, strategy, last_majorities, decisions,
    counter_rows[, leaders])``."""
    if state.device.type == "cpu":
        return pipeline.coalesced_megastep(
            state, sched, strategy, slot_counters, events, rounds=rounds, m=m,
            max_liars=max_liars, scenario=scenario,
        )
    if m != 1:
        raise ValueError(f"the megastep kernel runs OM(1) only (m == 1), got m={m}")
    if scenario != (events is not None):
        raise ValueError("scenario mode takes event planes, and only it does")
    _, leaders, decisions, rows, majorities = _launch(
        state, sched, strategy, slot_counters, events,
        rounds=rounds, collect_decisions=True, slot=True,
    )
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        cuda_coalesced_megastep.launches += 1
    out = (state, sched, strategy, majorities, decisions, rows)
    if scenario:
        out += (leaders,)
    return out


cuda_pipeline_megastep.launches = 0
cuda_scenario_megastep.launches = 0
cuda_coalesced_megastep.launches = 0


def count_graph_replay() -> None:
    """A replay of a CUDA graph that holds one slot-mode launch
    (``obs/graphcache.py``) launches the kernel once: its count is the
    slot mode's, like the wrapper's own launches."""
    cuda_coalesced_megastep.launches += 1


def reset_launches() -> None:
    cuda_pipeline_megastep.launches = 0
    cuda_scenario_megastep.launches = 0
    cuda_coalesced_megastep.launches = 0
