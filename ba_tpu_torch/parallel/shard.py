"""Mesh-sharded megasteps (``ba_tpu/parallel/shard.py``): the pipelined
scan cores run once a "data" shard, so the batch, every carry plane and
every staged event plane split across the mesh's entries.

- **Sharding is layout only.**  Instances are independent, and each shard
  folds its per-instance keys by GLOBAL instance index
  (``round_keys(..., index_base=shard * B / d)``), so decisions, leaders,
  histograms and every counter match the single-device run bit for bit.
- **Per-shard outputs, reduced at retire.**  Each shard folds its own
  counter block (``[d, C]`` global, a ``[1, C]`` piece each) and emits its
  own per-round histogram contribution (``[R, d, 3]``); the engine sums
  them on the host inside the retire fetch it already makes
  (:func:`reduce_host_ys`), so the result, ``on_rows`` and checkpoints see
  the same blocks at any d.  The one collective a round is the 3-int
  histogram sum for the global unanimity verdict, when counters are on
  (``pipeline.agreement_counter_delta``): an add on the first entry's
  device within a process, an ``all_reduce`` on the current stream
  across processes.
- **In place, as the single-device megasteps.**  Each shard updates its
  own pieces of the state, schedule and strategy plane.

Checkpoints are device-count-free: the engine gathers the per-shard
counter blocks to the canonical block when it writes (gather on write)
and splits a canonical block again on resume (:func:`expand_counters`,
reshard on read), so a campaign checkpointed on d entries resumes
bit-exactly on d'.
"""

from __future__ import annotations

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.parallel import pipeline as _pipeline
from ba_tpu_torch.parallel.mesh import (
    Mesh, P, Sharded, axis_index, gather_tree, shard_map, tree_map,
)
from ba_tpu_torch.parallel.multihost import put_global

DATA_AXIS = "data"

STATE_SPECS = SimState(order=P(DATA_AXIS), leader=P(DATA_AXIS), faulty=P(DATA_AXIS, None),
                       alive=P(DATA_AXIS, None), ids=P(DATA_AXIS, None))
SCHED_SPECS = _pipeline.KeySchedule(key_data=P(None), counter=P())
COUNTER_SPECS = P(DATA_AXIS, None)  # [d, C] per-shard blocks
STRATEGY_SPECS = P(DATA_AXIS, None)
EVENT_SPECS = P(None, DATA_AXIS, None)  # [R, B, n] planes
ROWS_SPECS = P(None, DATA_AXIS, None)  # [R, d, 3] histograms, [R, d, C] counter rows
INSTANCE_SPECS = P(None, DATA_AXIS)  # [R, B] decisions / leaders


def validate_mesh(mesh: Mesh, batch: int) -> int:
    """The mesh's data-axis size, after the eager layout checks (before
    any buffer is staged)."""
    if DATA_AXIS not in mesh.shape:
        raise ValueError(
            f"mesh axes {tuple(mesh.shape)} carry no {DATA_AXIS!r} axis — "
            f"the engine shards the batch on it (make_mesh's default "
            f"layout)"
        )
    d = int(mesh.shape[DATA_AXIS])
    if batch % d:
        raise ValueError(
            f"batch {batch} is not divisible by the mesh's {DATA_AXIS!r} "
            f"axis ({d} device(s)) — pad the batch or shrink the mesh"
        )
    return d


def shard_layout(mesh: Mesh) -> dict:
    """Every axis's size, ``{axis: size}``: the layout recorded in carry
    checkpoint headers (the stored arrays are canonical)."""
    return {name: int(size) for name, size in mesh.shape.items()}


def expand_counters(mesh: Mesh, counters) -> Sharded:
    """A canonical counter block -> per-shard blocks ``[d, C]`` on
    ``mesh`` (reshard on read): shard 0 takes the whole prior total, the
    others start at zero, since only the sum is ever read.  A 2-D block
    (a live per-shard carry, possibly of another d) is summed first."""
    counters = gather_tree(counters)
    if counters.dim() == 2:
        counters = counters.sum(dim=0, dtype=counters.dtype)
    d = int(mesh.shape[DATA_AXIS])
    block = torch.zeros((d,) + tuple(counters.shape), dtype=counters.dtype,
                        device=counters.device)
    block[0] = counters
    return put_global(mesh, block, COUNTER_SPECS)


def _leaves(tree) -> list:
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def per_shard_nbytes(tree) -> int:
    """Bytes ONE mesh entry holds for a tree of (possibly sharded) values:
    a Sharded leaf by its piece, any other tensor in full."""
    total = 0
    for x in _leaves(tree):
        if isinstance(x, Sharded):
            t = next(iter(x.pieces.values()))
            total += t.numel() * t.element_size()
        else:
            total += x.numel() * x.element_size()
    return total


def per_shard_nbytes_all(tree) -> list:
    """Bytes each mesh entry this process owns holds for a tree of
    (possibly sharded) values, sorted descending (``max / mean`` is the
    imbalance); tensors that are not sharded count nowhere."""
    per: dict = {}
    for x in _leaves(tree):
        if isinstance(x, Sharded):
            for pos, t in x.pieces.items():
                per[pos] = per.get(pos, 0) + t.numel() * t.element_size()
    return sorted(per.values(), reverse=True)


def reduce_host_ys(host_ys: tuple, *, scenario: bool, collect_decisions: bool,
                   with_counters: bool) -> tuple:
    """One retire's fetched per-shard blocks -> the canonical
    single-device shapes, on host numpy the fetch already brought back:
    histograms ``[R, d, 3]`` and cumulative counter rows ``[R, d, C]`` sum
    over the shard axis; decisions and leaders arrive whole ``[R, B]``."""
    ys = list(host_ys)
    ys[0] = ys[0].sum(axis=1, dtype=ys[0].dtype)
    if scenario:
        ys[2] = ys[2].sum(axis=1, dtype=ys[2].dtype)
    elif with_counters:
        ys[-1] = ys[-1].sum(axis=1, dtype=ys[-1].dtype)
    return tuple(ys)


def sharded_pipeline_megastep(  # ba-lint: donates(state, sched)
        state, sched, *, mesh: Mesh, rounds: int, m: int = 1, max_liars: int | None = None,
        collect_decisions: bool = False, counters=None):
    """``pipeline.pipeline_megastep`` batch-sharded over ``mesh``'s "data"
    axis: the same scan core a shard, in place, the same return tuple,
    except histograms come back per shard ``[rounds, d, 3]`` and counter
    rows ``[rounds, d, C]`` (``counters`` is a ``[d, C]`` block from
    :func:`expand_counters`), for the host to sum at retire.  The state
    and schedule are Sharded values on ``mesh``."""
    with_counters = counters is not None

    def run(st, sc, *rest):
        ctr = rest[0] if rest else None
        base = axis_index(DATA_AXIS) * st.batch
        carry, ys = _pipeline._pipeline_scan(
            st, sc, ctr, rounds=rounds, m=m, max_liars=max_liars,
            collect_decisions=collect_decisions, index_base=base,
            axis_name=DATA_AXIS if with_counters else None,
        )
        sc.counter.copy_(carry[1].counter)
        return (st, sc, ys[0][:, None, :]) + ys[1:]

    out_specs = (STATE_SPECS, SCHED_SPECS, ROWS_SPECS)
    if collect_decisions:
        out_specs += (INSTANCE_SPECS,)
    if with_counters:
        out_specs += (ROWS_SPECS,)
    args = (state, sched) + ((counters,) if with_counters else ())
    return shard_map(run, mesh, out_specs, collectives=with_counters)(*args)


def sharded_scenario_megastep(  # ba-lint: donates(state, sched, strategy)
        state, sched, strategy, counters, events: dict, *, mesh: Mesh, rounds: int, m: int = 1,
        max_liars: int | None = None, collect_decisions: bool = False):
    """``pipeline.scenario_megastep`` batch-sharded over ``mesh``'s "data"
    axis: kills, revivals, flips and re-election are per instance, so the
    whole mutating round is shard-local apart from the counter delta's
    histogram sum.  Updates each shard's state, strategy and schedule
    pieces in place; returns ``(state, sched, strategy, histograms [R, d,
    3], leaders [R, B], counter_rows [R, d, C][, decisions [R, B]])``."""

    def run(st, sc, strat, ctr, ev):
        base = axis_index(DATA_AXIS) * st.batch
        (st2, sc2, strat2, _), ys = _pipeline._scenario_scan(
            st, sc, strat, ctr, ev, rounds=rounds, m=m, max_liars=max_liars,
            collect_decisions=collect_decisions, index_base=base, axis_name=DATA_AXIS,
        )
        for name in ("leader", "faulty", "alive"):
            getattr(st, name).copy_(getattr(st2, name))
        strat.copy_(strat2)
        sc.counter.copy_(sc2.counter)
        return (st, sc, strat, ys[0][:, None, :]) + ys[1:]

    out_specs = (STATE_SPECS, SCHED_SPECS, STRATEGY_SPECS, ROWS_SPECS, INSTANCE_SPECS,
                 ROWS_SPECS)
    if collect_decisions:
        out_specs += (INSTANCE_SPECS,)
    return shard_map(run, mesh, out_specs)(state, sched, strategy, counters, events)


def host_chunk_pieces(mesh: Mesh, chunk: dict) -> dict:
    """A host chunk of ``[R, B, n]`` planes split by position: position ->
    {plane: its ``[R, B/d, n]`` numpy slice} for each entry this process
    owns (the staging of each shard's planes)."""
    d = int(mesh.shape[DATA_AXIS])
    a = mesh.axis(DATA_AXIS)
    out = {}
    for pos in mesh.local_positions:
        k = pos[a]
        out[pos] = {name: np.ascontiguousarray(v[:, k * (v.shape[1] // d):
                                                  (k + 1) * (v.shape[1] // d)])
                    for name, v in chunk.items()}
    return out


__all__ = [
    "DATA_AXIS", "expand_counters", "host_chunk_pieces", "per_shard_nbytes",
    "per_shard_nbytes_all", "reduce_host_ys", "shard_layout", "sharded_pipeline_megastep",
    "sharded_scenario_megastep", "validate_mesh",
]
