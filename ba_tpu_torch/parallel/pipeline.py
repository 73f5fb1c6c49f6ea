"""Pipelined multi-round sweep engine (``ba_tpu/parallel/pipeline.py``).

- **Key schedule** (:class:`KeySchedule`): one base key plus an int32
  round counter, both on the device.  Round ``r``, instance ``i`` draws
  from ``fold_in(fold_in(base, counter + r), i)`` — the reference's
  schedule, derived on the device, never uploaded per round.
- **Megasteps**: one dispatch runs ``rounds`` rounds.  The plain engine
  (``engine="torch"``) is :func:`pipeline_megastep` /
  :func:`scenario_megastep` over the scan cores :func:`_pipeline_scan` /
  :func:`_scenario_scan`; the Hopper kernel (``engine="cuda"``) is
  ``ops/scenario_step.py``'s twins with the same signatures and returns.
  K1 runs OM(1) only: at m != 1 the composed torch engine runs OM(m) by
  the EIG tree (K9 at every resolve level on the card), and an explicit
  ``engine="cuda"`` raises (:func:`engine_support`).
- **In-place carry**: jax's donation becomes in-place reuse.  A megastep
  writes the advanced counter and the mutated state / strategy planes
  back into the tensors it was given and returns those same objects.
  A caller that needs the state from before the run copies it first
  (:func:`fresh_copy`).
- **Depth-k in flight**: :func:`pipeline_sweep` keeps up to ``depth``
  dispatches un-retired.  Each dispatch's outputs are copied into pinned
  host memory with ``non_blocking=True`` and a CUDA event is recorded;
  the only synchronization is waiting on that event ``depth`` dispatches
  later.  Host work (``host_work``) and the next scenario chunk's upload
  overlap the dispatches in flight.
- **Carry checkpoints**: with ``checkpoint_every`` the sweep queues a
  pinned host copy of the live carry right after the dispatch on each
  boundary and writes it in the JAX package's file format
  (``utils/snapshot.py``) when that dispatch retires; ``resume=`` takes
  such a file, from either package, and continues bit-exactly
  (:class:`CarryCheckpoint`).
- **Coalesced serving batch**: :func:`coalesced_sweep` runs B independent
  requests as one batch.  Its schedule holds one base key per slot and
  every slot folds instance index 0 (:func:`slot_round_keys`), and each
  slot keeps its own counter block (:func:`slot_counter_delta`), so slot
  ``b`` is bit-identical to its own B = 1 run at equal padded capacity.
- **Signed SM(m)**: ``signed=True`` runs :func:`signed_megastep` (or
  :func:`coalesced_signed_megastep`), each round a
  ``signed_agreement_step`` gated on that round's table verdicts, which
  the sign-ahead lane (``parallel/signing.py``) signs and verifies while
  the earlier dispatches are in flight.  The reference runs these
  megasteps in XLA, never in a Pallas kernel, so they are plain torch on
  every device (``engine="torch"``); the lane's verify launches K7, K5,
  K4 and K3 on the card.  Counters are always on
  (SIGNED_COUNTER_NAMES).
- **Mesh**: ``mesh=`` splits the batch over a device mesh's "data" axis
  (``parallel/shard.py``): the same scan cores a shard, keys folded by
  global instance index, per-shard counter blocks and histogram rows
  summed at retire, checkpoints gathered on write and split again on
  read.  Every mesh dispatch runs the shard-mapped torch scan core, as
  the reference's runs its XLA one (``engine="cuda"`` raises).
- **Dispatch spans**: every megastep dispatch of the three loops runs in
  a ``compile`` (the first of its named signature, ``obs/instrument.py``)
  or ``dispatch`` span, a warm graph-cache entry's always ``dispatch``
  with ``warm=True``, inside ``obs.cuda.annotate("megastep_dispatch" |
  "coalesced_dispatch")``; the first dispatch of a ``"cuda"`` signature
  off a mesh, with the sink live, emits K1's ``compiled_artifact`` record
  (``obs/cuda.py``).  None of it waits for the card.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
import weakref

import numpy as np
import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.election import elect_lowest_id
from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.core.types import ATTACK, RETREAT, UNDEFINED
from ba_tpu_torch import obs
from ba_tpu_torch.obs import flight
from ba_tpu_torch.parallel import mesh as _mesh
from ba_tpu_torch.parallel.sweep import agreement_step, signed_agreement_step
from ba_tpu_torch.utils import metrics as _metrics
from ba_tpu_torch.utils import snapshot

COUNTER_NAMES = ("quorum_failures", "unanimous_rounds", "equivocation_observed")
SCENARIO_COUNTER_NAMES = COUNTER_NAMES + ("ic1_violations", "ic2_violations")
# The signed engine's block: the agreement counters, then instances whose
# round table held a rejected signature, and instances whose faulty, alive
# commander reached its lieutenants with both orders.
SIGNED_COUNTER_NAMES = COUNTER_NAMES + ("sig_rejections", "commander_equivocations")

ENGINES = ("torch", "cuda")
EVENT_PLANES = ("kill", "revive", "set_faulty", "set_strategy")


@dataclasses.dataclass(frozen=True)
class KeySchedule:
    """Device-resident PRNG schedule: base key data (int64 ``[2]`` of
    uint32 words) and the int32 count of rounds consumed."""

    key_data: torch.Tensor
    counter: torch.Tensor


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor: a SimState,
    KeySchedule, tensor, None, or a tuple / list / dict of them (a
    Sharded value: to each of its pieces)."""
    return _mesh.tree_map(lambda x: x.map(fn) if isinstance(x, _mesh.Sharded) else fn(x), tree)


def fresh_copy(tree, device=None):
    """A live copy of a SimState, KeySchedule, tensor, or a tuple / list /
    dict of them, on ``device`` (default: where each tensor lies; a
    Sharded value stays sharded, or with a ``device`` is gathered there).
    Megasteps update their carry in place, so a caller that needs the
    pre-run state afterwards copies it first."""
    if device is None:
        return _map_tensors(torch.clone, tree)
    return _map_tensors(lambda t: t.to(device, copy=True), _mesh.gather_tree(tree))


def make_key_schedule(key: torch.Tensor, counter: int = 0) -> KeySchedule:
    """A :class:`KeySchedule` for ``key`` starting at round ``counter``;
    the key data is copied, so the caller's key survives the run."""
    return KeySchedule(
        key_data=key.to(torch.int64).clone(),
        counter=torch.tensor(counter, dtype=torch.int32, device=key.device),
    )


def round_keys(sched: KeySchedule, batch: int, index_base: int = 0) -> torch.Tensor:
    """The current round's per-instance keys ``[batch, 2]``:
    ``fold_in(fold_in(base, counter), index_base + i)``.  ``index_base``
    is the global index of the first instance (a slice of a larger batch
    draws the same streams as the whole)."""
    kr = rng.fold_in(sched.key_data, sched.counter)
    idx = torch.arange(batch, dtype=torch.int64, device=kr.device) + index_base
    return rng.fold_in(kr[None, :], idx)


def make_slot_key_schedule(slot_keys, counter: int = 0) -> KeySchedule:
    """A :class:`KeySchedule` holding one base key PER SLOT: ``key_data``
    int64 ``[B, 2]`` (the slots' keys stacked, so copied) and an int32
    counter."""
    data = torch.stack([torch.as_tensor(k) for k in slot_keys]).to(torch.int64)
    return KeySchedule(
        key_data=data,
        counter=torch.tensor(counter, dtype=torch.int32, device=data.device),
    )


def slot_round_keys(sched: KeySchedule) -> torch.Tensor:
    """The current round's per-slot keys ``[B, 2]`` from a slot schedule:
    slot ``b`` draws ``fold_in(fold_in(base_b, counter), 0)``, the key
    its own B = 1 run derives for instance 0.  The folded index is 0 for
    every slot: that is the whole bit-exactness contract."""
    return rng.fold_in(rng.fold_in(sched.key_data, sched.counter), 0)


def agreement_counters_init(device=None) -> torch.Tensor:
    return torch.zeros(len(COUNTER_NAMES), dtype=torch.int32, device=resolve_device(device))


def scenario_counters_init(device=None) -> torch.Tensor:
    return torch.zeros(
        len(SCENARIO_COUNTER_NAMES), dtype=torch.int32, device=resolve_device(device)
    )


def _disagree(maj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B] bool: the masked majorities hold more than one value.  The
    int8 +-127 sentinels are the reference's (``pipeline.py:360``)."""
    big = torch.tensor(127, dtype=maj.dtype, device=maj.device)
    mmax = torch.where(mask, maj, -big).amax(dim=1)
    mmin = torch.where(mask, maj, big).amin(dim=1)
    return (mmax != mmin) & mask.any(dim=1)


def _lieutenants(state: SimState) -> torch.Tensor:
    idx = torch.arange(state.n, device=state.device)
    return state.alive & (idx[None, :] != state.leader[:, None])


def slot_counter_delta(out: dict, state: SimState, scenario: bool) -> torch.Tensor:
    """One round's counter increments per instance, int32 ``[B, C]``: row
    ``b`` is what a B = 1 run of instance ``b`` alone folds into its
    block.  Columns: the decision is UNDEFINED; 1 (one instance always
    decides unanimously); a live traitor is present and the alive
    lieutenants disagree; in scenario mode also IC1 (honest alive
    lieutenants disagree) and IC2 (the commander is honest yet an honest
    alive lieutenant's majority differs from its order)."""
    decision = out["decision"]
    maj = out["majorities"]
    lieutenants = _lieutenants(state)
    traitor_present = (state.faulty & state.alive).any(dim=1)
    cols = [decision == UNDEFINED, torch.ones_like(traitor_present),
            _disagree(maj, lieutenants) & traitor_present]
    if scenario:
        honest_lt = lieutenants & ~state.faulty
        leader_faulty = state.faulty.gather(1, state.leader.long()[:, None])[:, 0]
        disobey = (honest_lt & (maj != state.order[:, None])).any(dim=1)
        cols += [_disagree(maj, honest_lt), ~leader_faulty & disobey]
    return torch.stack(cols, dim=-1).to(torch.int32)


def _batch_counter_delta(out: dict, state: SimState, scenario: bool,
                         axis_name: str | None) -> torch.Tensor:
    delta = slot_counter_delta(out, state, scenario).sum(dim=0, dtype=torch.int32)
    if axis_name is None:
        delta[1] = (out["histogram"].max() == out["decision"].shape[0]).to(torch.int32)
    else:
        hist = _mesh.psum(out["histogram"], axis_name)
        # the bins partition the whole batch: max == sum is "one bin holds everyone"
        unanimous = (hist.max() == hist.sum()).to(torch.int32)
        delta[1] = unanimous if _mesh.axis_index(axis_name) == 0 else 0
    return delta


def agreement_counter_delta(out: dict, state: SimState,
                            axis_name: str | None = None) -> torch.Tensor:
    """One round's increments of COUNTER_NAMES, int32 ``[3]``:
    UNDEFINED quorum decisions, 1 if every instance decided alike, and
    instances with a live traitor whose alive lieutenants disagree.

    ``axis_name`` is the mesh's shard axis when a shard_map body calls
    it: the per-instance counts stay shard-local (the shards' blocks sum
    to the single-device block), but unanimity is a property of the whole
    batch, so the 3-bin histogram is summed over the axis and the verdict
    credited to shard 0 alone."""
    return _batch_counter_delta(out, state, False, axis_name)


def scenario_counter_delta(out: dict, state: SimState,
                           axis_name: str | None = None) -> torch.Tensor:
    """The agreement deltas followed by the IC1 / IC2 instance counts,
    int32 ``[5]`` (the verdicts of :func:`slot_counter_delta`);
    ``axis_name`` as in :func:`agreement_counter_delta`."""
    return _batch_counter_delta(out, state, True, axis_name)


def _advanced(sched: KeySchedule, rounds: int) -> KeySchedule:
    return KeySchedule(sched.key_data, sched.counter + rounds)


def _pipeline_scan(
    state: SimState,
    sched: KeySchedule,
    counters,
    *,
    rounds: int,
    m: int = 1,
    max_liars: int | None = None,
    collect_decisions: bool = False,
    index_base: int = 0,
    axis_name: str | None = None,
):
    """The plain (non-mutating) scan core.  Returns ``(carry, ys)`` with
    carry ``(state, sched[, counters])`` and ys ``(histograms[,
    decisions][, counter_rows])``, stacked over rounds.  ``index_base``
    and ``axis_name`` are the mesh's seam (``parallel/shard.py``): a shard
    folds its keys by global instance index, and the counter delta sums
    the histogram over the axis."""
    hists, decs, rows = [], [], []
    for r in range(rounds):
        keys = round_keys(_advanced(sched, r), state.batch, index_base)
        out = agreement_step(keys, state, m=m, max_liars=max_liars)
        hists.append(out["histogram"])
        if collect_decisions:
            decs.append(out["decision"])
        if counters is not None:
            counters = counters + agreement_counter_delta(out, state, axis_name)
            rows.append(counters)
    ys = (torch.stack(hists),)
    if collect_decisions:
        ys += (torch.stack(decs),)
    carry = (state, _advanced(sched, rounds))
    if counters is not None:
        ys += (torch.stack(rows),)
        carry += (counters,)
    return carry, ys


def _apply_events(st: SimState, strat: torch.Tensor, events: dict, r: int):
    """Round ``r``'s transition: ``alive = (alive & ~kill) | revive``,
    tri-state fault / strategy flips (-1 = keep), then instances whose
    leader died re-elect the lowest alive id (a living leader is never
    displaced).  Returns the new (state, strategy)."""
    kill, revive = events["kill"][r], events["revive"][r]
    fset, sset = events["set_faulty"][r], events["set_strategy"][r]
    alive = (st.alive & ~kill) | revive
    faulty = torch.where(fset >= 0, fset > 0, st.faulty)
    strat = torch.where(sset >= 0, sset, strat)
    leader_alive = alive.gather(1, st.leader.long()[:, None])[:, 0]
    leader = torch.where(leader_alive, st.leader, elect_lowest_id(st.ids, alive))
    return SimState(st.order, leader, faulty, alive, st.ids), strat


def _scenario_scan(
    state: SimState,
    sched: KeySchedule,
    strategy: torch.Tensor,
    counters: torch.Tensor,
    events: dict,
    *,
    rounds: int,
    m: int = 1,
    max_liars: int | None = None,
    collect_decisions: bool = False,
    index_base: int = 0,
    axis_name: str | None = None,
):
    """The mutating-round scan core.  Per round: the event transition
    (:func:`_apply_events`), then the strategy-aware round, and the
    scenario counters fold (``index_base`` / ``axis_name`` as in
    :func:`_pipeline_scan`).

    Returns ``(carry, ys)`` with carry ``(state, sched, strategy,
    counters)`` and ys ``(histograms, leaders, counter_rows[,
    decisions])`` — leaders post-election, counter rows cumulative.
    """
    hists, leaders, rows, decs = [], [], [], []
    st, strat = state, strategy
    for r in range(rounds):
        st, strat = _apply_events(st, strat, events, r)
        keys = round_keys(_advanced(sched, r), st.batch, index_base)
        out = agreement_step(keys, st, m=m, max_liars=max_liars, strategies=strat)
        counters = counters + scenario_counter_delta(out, st, axis_name)
        hists.append(out["histogram"])
        leaders.append(st.leader)
        rows.append(counters)
        if collect_decisions:
            decs.append(out["decision"])
    ys = (torch.stack(hists), torch.stack(leaders), torch.stack(rows))
    if collect_decisions:
        ys += (torch.stack(decs),)
    return (st, _advanced(sched, rounds), strat, counters), ys


def pipeline_megastep(  # ba-lint: donates(state, sched)
    state: SimState,
    sched: KeySchedule,
    *,
    rounds: int,
    m: int = 1,
    max_liars: int | None = None,
    collect_decisions: bool = False,
    counters=None,
):
    """``rounds`` agreement rounds in one dispatch (the plain engine).

    Returns ``(state, sched, histograms[, decisions][, counter_rows])``:
    histograms ``[rounds, 3]`` int32, decisions ``[rounds, B]`` int8,
    counter_rows ``[rounds, 3]`` cumulative int32 (given ``counters``,
    the previous block).  The schedule's counter advances in place.
    """
    carry, ys = _pipeline_scan(
        state, sched, counters, rounds=rounds, m=m, max_liars=max_liars,
        collect_decisions=collect_decisions,
    )
    sched.counter.copy_(carry[1].counter)
    return (state, sched, *ys)


def scenario_megastep(  # ba-lint: donates(state, sched, strategy)
    state: SimState,
    sched: KeySchedule,
    strategy: torch.Tensor,
    counters: torch.Tensor,
    events: dict,
    *,
    rounds: int,
    m: int = 1,
    max_liars: int | None = None,
    collect_decisions: bool = False,
):
    """``rounds`` mutating rounds in one dispatch (the plain engine).

    ``events`` holds ``[rounds, B, n]`` planes (kill / revive bool,
    set_faulty / set_strategy int8 with -1 = keep).  Returns ``(state,
    sched, strategy, histograms, leaders, counter_rows[, decisions])``;
    the state planes, leader, strategy plane and counter are updated in
    place.
    """
    (st, sc, strat, _), ys = _scenario_scan(
        state, sched, strategy, counters, events,
        rounds=rounds, m=m, max_liars=max_liars, collect_decisions=collect_decisions,
    )
    for name in ("leader", "faulty", "alive"):
        getattr(state, name).copy_(getattr(st, name))
    strategy.copy_(strat)
    sched.counter.copy_(sc.counter)
    return (state, sched, strategy, *ys)


def coalesced_megastep(  # ba-lint: donates(state, sched, strategy)
    state: SimState,
    sched: KeySchedule,
    strategy,
    slot_counters: torch.Tensor,
    events,
    *,
    rounds: int,
    m: int = 1,
    max_liars: int | None = None,
    scenario: bool = False,
):
    """``rounds`` rounds of a coalesced serving batch in one dispatch (the
    plain engine); every slot is an independent request.

    ``sched`` is a slot schedule (:func:`make_slot_key_schedule`), so slot
    ``b``'s decisions, majorities and counters are bit-identical to its
    own B = 1 run at equal padded capacity.  ``slot_counters`` is the
    ``[B, C]`` block (C = 5 in scenario mode, else 3).  With
    ``scenario=True`` each round first applies ``events`` (``[rounds, B,
    n]`` planes, the slots' campaigns side by side along the batch) and
    re-elects, as :func:`scenario_megastep` does; ``strategy`` is the
    ``[B, n]`` plane there (``None`` in plain mode).

    Returns ``(state, sched, strategy, last_majorities, decisions,
    counter_rows[, leaders])``: ``last_majorities`` int8 ``[B, n]`` is the
    final round's majority plane for every general, dead ones included;
    ``decisions`` int8 ``[rounds, B]``; ``counter_rows`` int32 ``[rounds,
    B, C]`` cumulative; ``leaders`` int32 ``[rounds, B]`` post-election
    (scenario only).  The state planes, leader, strategy plane and the
    schedule's counter are updated in place.
    """
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    st, strat, ctr = state, strategy, slot_counters
    decs, rows, leaders = [], [], []
    for r in range(rounds):
        if scenario:
            st, strat = _apply_events(st, strat, events, r)
            leaders.append(st.leader)
        out = agreement_step(slot_round_keys(_advanced(sched, r)), st, m=m,
                             max_liars=max_liars, strategies=strat if scenario else None)
        ctr = ctr + slot_counter_delta(out, st, scenario)
        decs.append(out["decision"])
        rows.append(ctr)
    if scenario:
        for name in ("leader", "faulty", "alive"):
            getattr(state, name).copy_(getattr(st, name))
        strategy.copy_(strat)
    sched.counter.add_(rounds)
    ys = (torch.stack(decs), torch.stack(rows))
    if scenario:
        ys += (torch.stack(leaders),)
    return (state, sched, strategy, out["majorities"], *ys)


def signed_counters_init(device=None) -> torch.Tensor:
    return torch.zeros(len(SIGNED_COUNTER_NAMES), dtype=torch.int32,
                       device=resolve_device(device))


def _signed_verdicts(out: dict, state: SimState, ok: torch.Tensor):
    """Per instance, [B] bool each: the round table held a rejected
    signature; the commander is faulty and alive and its alive
    lieutenants received both orders this round."""
    lieutenants = _lieutenants(state)
    received = out["received"]
    got_a = ((received == ATTACK) & lieutenants).any(dim=1)
    got_r = ((received == RETREAT) & lieutenants).any(dim=1)
    leader = state.leader.long()[:, None]
    leader_faulty = state.faulty.gather(1, leader)[:, 0]
    leader_alive = state.alive.gather(1, leader)[:, 0]
    return (~ok).any(dim=-1), got_a & got_r & leader_faulty & leader_alive


def signed_counter_delta(out: dict, state: SimState, ok: torch.Tensor) -> torch.Tensor:
    """One signed round's increments, int32 ``[5]``: the agreement deltas,
    then ``sig_rejections`` (instances whose table ``ok`` [B, V] holds a
    False) and ``commander_equivocations`` (faulty alive commanders whose
    alive lieutenants received both orders)."""
    rejected, equivocated = _signed_verdicts(out, state, ok)
    extra = torch.stack([rejected.sum(dtype=torch.int32), equivocated.sum(dtype=torch.int32)])
    return torch.cat([agreement_counter_delta(out, state), extra])


def slot_signed_counter_delta(out: dict, state: SimState, ok: torch.Tensor) -> torch.Tensor:
    """:func:`signed_counter_delta` per slot, int32 ``[B, 5]``: row ``b``
    is what slot ``b``'s own B = 1 signed run folds."""
    rejected, equivocated = _signed_verdicts(out, state, ok)
    extra = torch.stack([rejected, equivocated], dim=-1).to(torch.int32)
    return torch.cat([slot_counter_delta(out, state, False), extra], dim=-1)


def _signed_scan(state: SimState, sched: KeySchedule, counters: torch.Tensor,
                 ok_planes: torch.Tensor, *, rounds: int, m: int = 1, collapsed: bool = False,
                 collect_decisions: bool = False):
    """The signed scan core.  Round r runs ``signed_agreement_step`` under
    ``round_keys`` at ``counter + r`` on the verdicts ``ok_planes[r]``
    ([rounds, B, V] bool).  Returns ``(carry, ys)`` with carry ``(state,
    sched, counters)`` and ys ``(histograms[, decisions], counter_rows)``,
    the layout of the plain scan with counters."""
    hists, decs, rows = [], [], []
    for r in range(rounds):
        keys = round_keys(_advanced(sched, r), state.batch)
        out = signed_agreement_step(keys, state, ok_planes[r], m=m, collapsed=collapsed)
        counters = counters + signed_counter_delta(out, state, ok_planes[r])
        hists.append(out["histogram"])
        if collect_decisions:
            decs.append(out["decision"])
        rows.append(counters)
    ys = (torch.stack(hists),) + ((torch.stack(decs),) if collect_decisions else ())
    return (state, _advanced(sched, rounds), counters), ys + (torch.stack(rows),)


def signed_megastep(  # ba-lint: donates(state, sched)
        state: SimState, sched: KeySchedule, counters: torch.Tensor, ok_planes: torch.Tensor,
        *, rounds: int, m: int = 1, collapsed: bool = False, collect_decisions: bool = False):
    """``rounds`` signed SM(m) rounds in one dispatch
    (``ba_tpu/parallel/pipeline.py:781``): the round-1 broadcast, each
    value gated on its table verdict, m relay rounds (collapsed with
    ``collapsed``) and the quorum, a round at a time.

    ``counters`` is the SIGNED_COUNTER_NAMES block, ``ok_planes`` the
    lane's ``[rounds, B, V]`` verdicts.  Returns ``(state, sched,
    histograms[, decisions], counter_rows)``: the state as given (signed
    rounds do not change it), the schedule with its counter advanced in
    place, counter_rows ``[rounds, 5]`` cumulative.  Round ``counter + r``
    equals :func:`signed_agreement_step` of that round's keys, which is
    what ``parallel/signing.sequential_signed_sweep`` runs.
    """
    (_, sc, _), ys = _signed_scan(state, sched, counters, ok_planes, rounds=rounds, m=m,
                                  collapsed=collapsed, collect_decisions=collect_decisions)
    sched.counter.copy_(sc.counter)
    return (state, sched, *ys)


def coalesced_signed_megastep(  # ba-lint: donates(state, sched)
        state: SimState, sched: KeySchedule, slot_counters: torch.Tensor,
        ok_planes: torch.Tensor, *, rounds: int, m: int = 1, collapsed: bool = False):
    """``rounds`` signed rounds of a coalesced serving batch in one
    dispatch (``ba_tpu/parallel/pipeline.py:861``).  ``sched`` is a slot
    schedule, so slot ``b`` is bit-identical to its own B = 1
    ``pipeline_sweep(signed=True)`` at equal padded capacity.  Returns
    ``(state, sched, None, last_majorities, decisions, counter_rows)``,
    :func:`coalesced_megastep`'s tuple with no strategy plane."""
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    ctr = slot_counters
    decs, rows = [], []
    for r in range(rounds):
        out = signed_agreement_step(slot_round_keys(_advanced(sched, r)), state, ok_planes[r],
                                    m=m, collapsed=collapsed)
        ctr = ctr + slot_signed_counter_delta(out, state, ok_planes[r])
        decs.append(out["decision"])
        rows.append(ctr)
    sched.counter.add_(rounds)
    return (state, sched, None, out["majorities"], torch.stack(decs),
            torch.stack(rows))


def engine_support(m: int = 1, n_shards: int = 1, signed: bool = False,
                   meshed: bool = False) -> str | None:
    """None when K1 covers this combination, else the reason it cannot
    (``ba_tpu/parallel/pipeline.py:109``): K1 runs oral OM(1) on one
    device only.  ``meshed`` covers a mesh whose data axis is 1: every
    mesh dispatch runs the shard-mapped torch scan core."""
    if signed:
        return ("signed=True (the signed megastep runs on the composed torch engine, "
                "as the reference's runs in XLA; K1 covers oral OM(1) only)")
    if m != 1:
        return f"m={m} (the dense EIG tree stays on the composed torch engine)"
    if n_shards != 1 or meshed:
        return (f"mesh data={n_shards} (every mesh dispatch runs the shard-mapped torch "
                f"scan core, as the reference's runs its shard_map-wrapped XLA one; "
                f"K1 is single-device)")
    return None


def resolve_engine(engine: str | None, device: torch.device, m: int = 1,
                   signed: bool = False, *, n_shards: int = 1, meshed: bool = False) -> str:
    """``None`` picks ``"cuda"`` on a CUDA device for oral OM(1) on one
    device, and ``"torch"`` on the CPU, at any other m (OM(m) by the EIG
    tree, which launches K9 at every resolve level on the card), for
    signed runs and on a mesh.  ``"cuda"`` off the card, at m != 1, with
    ``signed``, on a mesh, or under the non-partitionable threefry mode
    (the kernel encodes only the partitionable one) raises: there is no
    fallback."""
    if m < 0:
        raise ValueError(f"m={m} must be >= 0")
    reason = engine_support(m, n_shards, signed, meshed)
    if engine is None:
        engine = "cuda" if device.type == "cuda" and reason is None else "torch"
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r} unknown; choose from {ENGINES}")
    if engine == "cuda":
        if reason is not None:
            raise ValueError(f"engine='cuda' cannot run {reason}")
        if device.type != "cuda":
            raise ValueError(f"engine='cuda' runs on a CUDA device, not {device}")
        if not rng.threefry_partitionable():
            raise ValueError(
                "engine='cuda' follows the partitionable threefry mode only"
            )
    return engine


def _engine_megasteps(engine: str):
    """(plain, scenario, coalesced) megasteps of ``engine``."""
    if engine == "torch":
        return pipeline_megastep, scenario_megastep, coalesced_megastep
    from ba_tpu_torch.ops import scenario_step

    return (scenario_step.cuda_pipeline_megastep, scenario_step.cuda_scenario_megastep,
            scenario_step.cuda_coalesced_megastep)


@dataclasses.dataclass(frozen=True)
class CarryCheckpoint:
    """A resumable snapshot of the engine's carry
    (``ba_tpu/parallel/pipeline.py``'s ``CarryCheckpoint``).

    The :class:`SimState`, the :class:`KeySchedule` (its counter is the
    campaign's round cursor; the threefry derivation is the same in both
    packages and on every engine, so the resumed key stream matches the
    uninterrupted one), the cumulative counter block, the live strategy
    plane (scenario campaigns) and ``round``.  ``counters`` / ``strategy``
    are ``None`` on carries that never had them.  A ``[d, C]`` counter
    block (one a device) sums to the canonical block when written, and
    ``shard_layout`` records the writer's layout (``{"data": 1}`` here).
    ``signed`` marks a signed campaign's carry (its counters are
    SIGNED_COUNTER_NAMES, and it resumes only a signed sweep); ``run_id``
    is the run that wrote it.
    """

    state: SimState
    schedule: KeySchedule
    counters: torch.Tensor | None
    strategy: torch.Tensor | None
    round: int
    shard_layout: dict | None = None
    signed: bool = False
    run_id: str | None = None


# Header fields the writer stamps itself: one set for _carry_meta's clash
# check and pipeline_sweep's eager checkpoint_meta check.
RESERVED_CARRY_META_KEYS = frozenset(
    {"format", "v", "round", "scenario", "signed", "counter_names",
     "sha256", "rounds_total", "shard_layout", "run_id", "traceparent"}
)

def _carry_meta(round_cursor: int, counters, strategy, shard_layout=None, run_id=None,
                signed=False, **extra) -> dict:
    """The carry header, key for key the JAX package's; ``traceparent`` is
    the writer's trace position (None untraced), which a supervised
    resume adopts."""
    clash = (RESERVED_CARRY_META_KEYS - {"rounds_total"}) & set(extra)
    if clash:
        raise ValueError(
            f"checkpoint meta key(s) {sorted(clash)} are reserved for the carry header"
        )
    names = None
    if counters is not None:  # the strategy plane, not the length, picks the table
        names = list(SCENARIO_COUNTER_NAMES if strategy is not None
                     else SIGNED_COUNTER_NAMES if signed else COUNTER_NAMES)
    return {
        "round": int(round_cursor),
        "scenario": strategy is not None,
        "signed": bool(signed),
        "counter_names": names,
        "shard_layout": shard_layout or {"data": 1},
        "run_id": run_id,
        "traceparent": obs.trace.current_traceparent(),
        **extra,
    }


def save_carry_checkpoint(path: str, ckpt: CarryCheckpoint, **extra) -> int:
    """Write a carry to ``path`` (atomic, versioned, the JAX package's
    format and dtypes).  The carry's tensors may lie on any device, or
    be Sharded values (gathered here); pass a carry no dispatch is
    rewriting (the sweep's ``checkpoint_every`` does this for you).  ``extra`` keys ride the header.  A ``[d, C]``
    counter block sums to the canonical block here (``shard_layout``
    defaults to ``{"data": d}`` then).  Returns the array bytes written."""
    from ba_tpu_torch import convert

    carry = _mesh.gather_tree((ckpt.state, ckpt.schedule, ckpt.counters, ckpt.strategy))
    arrays = convert.carry_to_numpy(*carry)
    layout = ckpt.shard_layout
    counters = arrays.get("counters")
    if counters is not None and counters.ndim == 2:
        if layout is None:
            layout = {"data": int(counters.shape[0])}
        arrays["counters"] = counters.sum(axis=0, dtype=counters.dtype)
    snapshot.write_carry_checkpoint(path, arrays, _carry_meta(
        ckpt.round, arrays.get("counters"), arrays.get("strategy"), shard_layout=layout,
        run_id=ckpt.run_id, signed=ckpt.signed, **extra))
    return sum(v.nbytes for v in arrays.values())


def load_carry_checkpoint(path: str, device=None) -> CarryCheckpoint:
    """Read and schema-check a carry checkpoint, written by either
    package, into owned tensors on ``device`` (default: the card).
    Refuses a counter block whose stored names differ from the table
    the header selects: the block is positional."""
    from ba_tpu_torch import convert

    meta, arrays = snapshot.read_carry_checkpoint(path)
    if "counters" in arrays:
        live = (SCENARIO_COUNTER_NAMES if meta.get("scenario")
                else SIGNED_COUNTER_NAMES if meta.get("signed") else COUNTER_NAMES)
        stored = meta.get("counter_names")
        if stored is not None and tuple(stored) != tuple(live):
            raise ValueError(
                f"checkpoint counter table {list(stored)} does not match this "
                f"build's {list(live)} — refusing to resume totals positionally"
            )
    state, sched, counters, strategy = convert.carry_from_numpy(arrays, resolve_device(device))
    return CarryCheckpoint(
        state=state, schedule=sched, counters=counters, strategy=strategy,
        round=meta["round"], shard_layout=meta.get("shard_layout"),
        signed=bool(meta.get("signed", False)), run_id=meta.get("run_id"),
    )


class _Inflight:
    """One dispatch's outputs on their way to the host: pinned copies
    queued behind the dispatch, and the event that marks them done.

    ``carry``, where given, is the live carry right after the dispatch,
    to be checkpointed.  On the card its pinned copy is queued on the
    compute stream behind the dispatch, before the next dispatch
    rewrites the carry in place, and the same event marks it done: the
    boundary's carry, with no device clone and no new wait.  On the CPU
    the carry is cloned, since the engine reuses it in place there too.
    Sharded outputs (a mesh run) copy each piece and record an event on
    every device they lie on; the fetch assembles the global blocks
    (across processes through the mesh's group)."""

    def __init__(self, ys, carry=None):
        if ys[0].is_cuda:
            self.host = tuple(_map_tensors(_pinned, y) for y in ys)
            self.carry = _map_tensors(_pinned, carry)
            self.done = []
            for dev in sorted({str(t.device) for y in ys for t in _pieces(y)}):
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(torch.device(dev)))
                self.done.append(event)
        else:
            self.host, self.done = ys, []
            self.carry = fresh_copy(carry)

    def fetch(self) -> tuple:
        for event in self.done:
            # The engine's one sanctioned wait: the depth-delayed retire.
            event.synchronize()  # ba-lint: disable=BA101 (the retire)
        return tuple(np.asarray(h) for h in self.host)


def _pieces(x) -> list:
    return list(x.pieces.values()) if isinstance(x, _mesh.Sharded) else [x]


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


_PLANE_DTYPES = {"kill": torch.bool, "revive": torch.bool,
                 "set_faulty": torch.int8, "set_strategy": torch.int8}


def _stage_chunk(host: dict, device: torch.device, stream=None):
    """Move one chunk of event planes to ``device``.  Returns (planes, the
    event the dispatch that reads them must wait on, or None).

    On the card each plane is copied once into pinned memory and uploaded
    on ``stream``, a side stream, so the upload overlaps the dispatches in
    flight.  The device planes come from the side stream's pool and are
    marked as used by the compute stream, so a freed plane is not handed
    out again before the dispatch that read it has run; the compute
    stream waits on the returned event before it reads them.  The caching
    host allocator keeps the pinned buffers until their copies have run."""
    if device.type != "cuda":
        return {name: torch.tensor(host[name]) for name in EVENT_PLANES}, None
    compute = torch.cuda.current_stream(device)
    pinned, planes = {}, {}
    for name in EVENT_PLANES:
        a = host[name]
        pinned[name] = torch.empty(a.shape, dtype=_PLANE_DTYPES[name], pin_memory=True)
        np.copyto(pinned[name].numpy(), a)  # ba-lint: disable=BA101 (a pinned host view)
    ready = torch.cuda.Event()
    with torch.cuda.stream(stream):
        for name, p in pinned.items():
            planes[name] = torch.empty(p.shape, dtype=p.dtype, device=device)
            planes[name].copy_(p, non_blocking=True)
            planes[name].record_stream(compute)
        ready.record(stream)
    return planes, ready


def _stage_chunk_mesh(host: dict, mesh, uploads: dict):
    """:func:`_stage_chunk` for a mesh: each owned entry's ``[R, B/d,
    n]`` slice staged on its device (so the whole chunk never lands on one
    entry), the planes as Sharded values.  Returns (planes, the events the
    dispatch must wait on)."""
    from ba_tpu_torch.parallel import shard as _shard

    pieces, events = {name: {} for name in EVENT_PLANES}, []
    for pos, chunk in _shard.host_chunk_pieces(mesh, host).items():
        dev = mesh.device(pos)
        planes, ready = _stage_chunk(chunk, dev, uploads.get(dev))
        for name in EVENT_PLANES:
            pieces[name][pos] = planes[name]
        if ready is not None:
            events.append((dev, ready))
    return {name: _mesh.Sharded(mesh, _shard.EVENT_SPECS, host[name].shape, pieces[name])
            for name in EVENT_PLANES}, events


def _chunks(rounds: int, rounds_per_dispatch: int) -> list:
    """Rounds a dispatch: full dispatches, then the remainder."""
    chunks = [rounds_per_dispatch] * (rounds // rounds_per_dispatch)
    if rounds % rounds_per_dispatch:
        chunks.append(rounds % rounds_per_dispatch)
    return chunks


def pipeline_sweep(  # ba-lint: donates(state)
    key: torch.Tensor | None,
    state: SimState | None,
    rounds: int,
    *,
    m: int = 1,
    max_liars: int | None = None,
    depth: int = 2,
    rounds_per_dispatch: int = 1,
    collect_decisions: bool = False,
    with_counters: bool = False,
    scenario=None,
    initial_strategy=None,
    host_work=None,
    on_event=None,
    signed: bool = False,
    collapsed: bool = False,
    sign_seed: int = 0,
    sign_coalesce: int = 2,
    pool=None,
    cache=None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_keep_last: int | None = None,
    checkpoint_meta: dict | None = None,
    on_checkpoint=None,
    on_rows=None,
    resume=None,
    run_id: str | None = None,
    traceparent: str | None = None,
    exec_seam=None,
    retire_timeout_s: float | None = None,
    on_stall=None,
    health_every: int | None = None,
    mesh=None,
    engine: str | None = None,
    device=None,
):
    """Run ``rounds`` sweep rounds through the depth-k pipelined engine.

    Dispatches ``ceil(rounds / rounds_per_dispatch)`` megasteps (the last
    sized to the remainder), keeping ``depth`` of them un-retired between
    loop iterations.  ``host_work(d)`` runs after dispatch ``d`` while the
    device works; ``on_event(kind, d)`` reports ``"dispatch"`` and
    ``"retire"``.  ``device`` (default: the card) and ``engine`` follow
    :func:`resolve_engine`; the state and key move to the device, and
    the state is consumed — use the returned ``final_state``.  At m != 1
    every round is OM(m) by the EIG tree on the composed torch engine
    (``max_liars`` caps its fused level's lying count; derive it from
    the state).

    ``signed=True`` runs signed SM(m) through :func:`signed_megastep` on
    the composed torch engine (``engine="cuda"`` raises), counters always
    on (SIGNED_COUNTER_NAMES), ``collapsed`` picking the O(B n) relay.
    A sign-ahead lane (``parallel/signing.SignAheadLane(B,
    seed=sign_seed, pool=pool, cache=cache)``) stages each window's table
    verdicts: window 0 before the loop, window d + 1 right after dispatch
    d, while the dispatches before it are in flight, up to
    ``sign_coalesce`` windows in one signing and verifying pass (the
    reference's ``BA_TPU_SIGN_COALESCE``).  A signed run takes no
    scenario block; ``collapsed`` needs ``signed``.

    With ``scenario`` (a compiled ``ScenarioBlock`` or
    ``SparseScenarioBlock`` of matching shape) every dispatch runs the
    mutating megastep, counters are always on (SCENARIO_COUNTER_NAMES),
    ``initial_strategy`` seeds the strategy plane (default all RANDOM),
    and each chunk of event planes uploads on a side stream while the
    previous dispatches are in flight.

    Checkpoints: with ``checkpoint_every=k`` the carry is checkpointed
    every k rounds, aligned up to the next dispatch boundary (and at the
    campaign's end when that boundary falls there): its pinned host copy
    is queued right after the dispatch and written to ``checkpoint_path``
    (a literal ``{round}`` takes the round cursor) when that dispatch
    retires, in the JAX package's format, so either package resumes it.
    ``checkpoint_keep_last=N`` prunes a ``{round}`` family to its N
    newest files after each write, ``checkpoint_meta`` rides every header
    (reserved keys raise), ``on_checkpoint(round, path)`` fires after each
    write, and ``on_rows(d, lo, hi, host_ys)`` receives each retired
    window's host block before the same retire's checkpoint.

    ``resume=`` (a :class:`CarryCheckpoint` or a path) continues a
    campaign from its cursor: pass ``key=None, state=None`` and the same
    ``rounds`` / ``scenario`` as the original run.  The resumed rounds
    are bit-exact with the uninterrupted run's tail, whatever engine or
    package wrote the checkpoint.  ``run_id`` names the run; without it
    the run takes the active run scope's id, else the checkpoint's, else
    one derived from the round count, the key data and the scenario
    (``obs/flight.py``).  The sweep runs inside a run scope of that id
    (its owner emits the ``flight_summary`` record), under
    ``traceparent``'s trace position when the thread has none
    (``obs.trace.inject_scope``), and writes one ``flight_span`` record a
    retired window when the sink is on.

    Resilience seams (host side; they add no wait on the device):

    - ``exec_seam(call, phase, dispatch, lo, hi)`` makes every megastep
      call (``phase="dispatch"``) and every retire fetch (``"retire"``)
      by calling ``call()`` itself, ``[lo, hi)`` the dispatch's rounds.
      A retire fetch may be called again.  A dispatch's carry counts as
      consumed just before its real call runs (the megasteps update it
      in place): calling it again then raises :class:`CarryConsumed`, a
      fatal fault, so a seam's retry in place is bit-exact exactly when
      its fault was raised before it called.
    - ``retire_timeout_s`` arms the sweep's one watchdog thread
      (:class:`_Watchdog`) around each retire fetch (a blocking
      CUDA-event wait, which frees the interpreter lock); a fetch that
      outlasts it records the ``dispatch_stalled`` instant,
      ``pipeline_stalls_total`` and ``stats["stalls"]`` and calls
      ``on_stall(dispatch, timeout_s)`` from the watchdog's thread, whose
      exceptions are swallowed.  The fetch itself runs on.
    - ``health_every=N`` takes one ``obs.health.HealthSampler(registry,
      timeout_s=retire_timeout_s)`` sample every N dispatches in
      ``host_work``'s slot (``stats["health_samples"]``).

    Each dispatch and retire feeds the ``pipeline_*`` instruments of the
    default registry (dispatch latency, retire lag, depth occupancy,
    dispatches, retires, rounds), from host clocks the loop reads anyway,
    a batch at a time: at each health sample and when the loop ends.

    ``mesh=`` (``parallel/mesh.py``) splits the batch over the mesh's
    "data" axis (the batch must divide it; checked before anything is
    staged): the state, the replicated schedule, the per-shard counter
    block ``[d, C]`` and the strategy plane are Sharded values, each
    chunk's event planes are staged a shard at a time, and every dispatch
    runs ``parallel/shard.py``'s megasteps, each shard folding its keys by
    global instance index, so the run is bit-exact with the single-device
    one.  The per-shard histogram and counter rows are summed at retire
    (``reduce_host_ys``), so ``on_rows`` and the result see the same
    blocks at any d; the one collective a round is the histogram sum of
    the unanimity verdict (an add within a process, an ``all_reduce`` on
    the current stream across processes), never a host sync.  The engine
    is ``"torch"`` (``engine="cuda"`` raises); ``final_state``,
    ``final_schedule``, ``final_strategy`` and ``final_counters`` (the
    live ``[d, C]`` block) come back Sharded.  Checkpoints gather on
    write (the counter blocks summed, ``shard_layout`` the mesh's axes in
    the header) and split again on read: ``resume=`` works at any d, a
    live carry of Sharded values included, with or without a mesh.
    ``signed=True`` takes no mesh.

    Returns a dict: ``histograms`` [rounds - start, 3] (the rounds this
    call ran); ``decisions`` with ``collect_decisions``; with counters
    ``counters`` (name -> int), ``counters_per_round`` and
    ``final_counters`` (the live block); in scenario mode ``leaders`` and
    ``final_strategy``; ``final_state``, ``final_schedule``; and
    ``stats`` (with ``start_round``, ``checkpoints``, each write's round,
    bytes and host ms in ``checkpoint_writes``, ``run_id``, ``signed``,
    ``stalls``, ``health_samples``, and the lane's ``sign_ahead_s``, ``sign_pool_workers``,
    ``sign_pool_s``, ``sign_cache_hits``, ``host_sign_s``,
    ``host_verify_s``; zeros on an oral run; ``engine`` and
    ``engine_fallback``, the reason K1 could not run the sweep, or None;
    ``shards``, ``carry_bytes_per_shard``, ``plane_peak_bytes`` and
    ``plane_peak_bytes_per_shard``).
    """
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    if rounds_per_dispatch < 1:
        raise ValueError(f"rounds_per_dispatch={rounds_per_dispatch} must be >= 1")
    _check_checkpointing(checkpoint_every, checkpoint_path, checkpoint_keep_last,
                         checkpoint_meta, on_checkpoint)
    if retire_timeout_s is not None and retire_timeout_s <= 0:
        raise ValueError(f"retire_timeout_s={retire_timeout_s} must be > 0")
    if on_stall is not None and retire_timeout_s is None:
        raise ValueError("on_stall needs retire_timeout_s")
    if health_every is not None and health_every < 1:
        raise ValueError(f"health_every={health_every} must be >= 1")
    if signed:
        if scenario is not None:
            raise ValueError("signed=True cannot take a scenario block (the signed "
                             "megastep has no mutating-round form)")
        if sign_coalesce < 1:
            raise ValueError(f"sign_coalesce={sign_coalesce} must be >= 1")
        if mesh is not None:
            raise ValueError("signed=True is single-device (mesh signed combos are "
                             "unsupported; shard by running independent sweeps)")
        with_counters = True
    elif collapsed:
        raise ValueError("collapsed= is the signed relay dial; it needs signed=True")
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device(mesh.local_positions[0])
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device} but the mesh's entries are {dev.type} devices")

    if isinstance(resume, (str, os.PathLike)):
        resume = load_carry_checkpoint(resume, dev)
    if resume is not None:
        if resume.signed != signed:
            raise ValueError(f"resume checkpoint signed={resume.signed} but this sweep has "
                             f"signed={signed} — a carry never crosses protocols")
        if key is not None or state is not None:
            raise ValueError("resume= supplies the carry: pass key=None, state=None")
        if initial_strategy is not None:
            raise ValueError("resume= supplies the strategy plane; initial_strategy "
                             "must be None")
        if not 0 <= resume.round < rounds:
            done = (" — the checkpoint is from a COMPLETED campaign; pass a larger "
                    "rounds=/scenario= to extend it" if resume.round == rounds else "")
            raise ValueError(f"resume cursor {resume.round} outside campaign "
                             f"[0, {rounds}){done}")
        start = resume.round
        state = fresh_copy(resume.state, dev)  # the checkpoint stays usable
    elif key is None or state is None:
        raise ValueError("pass key and state, or resume= with key=None, state=None")
    else:
        start = 0
        state = _mesh.gather_tree(state, dev) if mesh is None else state
    B, n = state.faulty.shape
    from ba_tpu_torch.parallel import shard as _shard  # it imports this module

    n_shards = 1 if mesh is None else _shard.validate_mesh(mesh, B)
    reason = engine_support(m, n_shards, signed, mesh is not None)
    engine = resolve_engine(engine, dev, m, signed, n_shards=n_shards,
                            meshed=mesh is not None)
    plain_fn, scen_fn, _ = _engine_megasteps(engine)

    strategy = None
    if scenario is not None:
        if scenario.rounds != rounds:
            raise ValueError(
                f"scenario block covers {scenario.rounds} round(s), sweep asked for {rounds}"
            )
        if (scenario.batch, scenario.n) != (B, n):
            raise ValueError(
                f"scenario block is [{scenario.batch}, {scenario.n}] per round, "
                f"state is [{B}, {n}]"
            )
        with_counters = True
        if resume is not None:
            if resume.strategy is None or resume.counters is None:
                raise ValueError("resume checkpoint has no strategy/counter planes — it "
                                 "was not taken from a scenario campaign")
            strategy = fresh_copy(resume.strategy, dev)
        elif initial_strategy is None:
            strategy = torch.zeros((B, n), dtype=torch.int8, device=dev)
        else:
            strategy = torch.as_tensor(_mesh.gather_tree(initial_strategy)).to(
                dev, torch.int8).clone()
            if strategy.shape != (B, n):
                raise ValueError(
                    f"initial_strategy shape {tuple(strategy.shape)} != {(B, n)}"
                )
    elif initial_strategy is not None:
        raise ValueError("initial_strategy needs a scenario block")
    elif resume is not None and resume.strategy is not None:
        raise ValueError("resume checkpoint carries a strategy plane but no scenario "
                         "block was passed")

    if resume is not None:
        sched = fresh_copy(resume.schedule, dev)
        if scenario is None and with_counters and resume.counters is None:
            raise ValueError("resume checkpoint has no counter block — the original "
                             "run had with_counters=False")
        if scenario is None and not with_counters and resume.counters is not None:
            raise ValueError("resume checkpoint carries a counter block; pass "
                             "with_counters=True so the totals keep accumulating")
        counters = fresh_copy(resume.counters, dev) if with_counters else None
        if counters is not None and counters.ndim == 2:  # one block a device: the sum
            counters = counters.sum(dim=0, dtype=torch.int32)
    else:
        sched = make_key_schedule(key.to(dev))
        if scenario is not None:
            counters = scenario_counters_init(dev)
        elif signed:
            counters = signed_counters_init(dev)
        else:
            counters = agreement_counters_init(dev) if with_counters else None
    if mesh is not None:
        state = _mesh.shard_state(mesh, state)
        sched = KeySchedule(*(_mesh.put_global(mesh, t, _mesh.P())
                              for t in (sched.key_data, sched.counter)))
        if counters is not None:
            counters = _shard.expand_counters(mesh, counters)
        if strategy is not None:
            strategy = _mesh.put_global(mesh, strategy, _shard.STRATEGY_SPECS)
        plain_fn = functools.partial(_shard.sharded_pipeline_megastep, mesh=mesh)
        scen_fn = functools.partial(_shard.sharded_scenario_megastep, mesh=mesh)

    def identity_material():
        from ba_tpu_torch import convert

        material = [f"signed:m={m}:collapsed={collapsed}"] if signed else []
        material.append(convert.key_data_to_numpy(
            key if key is not None else resume.schedule.key_data).tobytes())
        if scenario is not None:
            doc = getattr(scenario, "to_doc", None)
            if doc is not None:
                material.append(json.dumps(doc(), sort_keys=True))
            else:  # a dense block: its planes' content
                material += [np.asarray(getattr(scenario, name)).tobytes()
                             for name in EVENT_PLANES]
        return material

    rid = flight.resolve_run_id(
        rounds, run_id=run_id, inherited=resume.run_id if resume is not None else None,
        material_fn=identity_material,
    )

    chunks = _chunks(rounds - start, rounds_per_dispatch)
    zero_staged: dict = {}
    devices = {dev} if mesh is None else {mesh.device(p) for p in mesh.local_positions}
    uploads = ({d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}
               if scenario is not None else {})
    plane_peak_bytes = 0

    def stage(lo, hi):
        nonlocal plane_peak_bytes
        empty = scenario.chunk_is_empty(lo, hi)
        if empty and hi - lo in zero_staged:
            return zero_staged[hi - lo]
        host = scenario.chunk(lo, hi)
        plane_peak_bytes = max(plane_peak_bytes, sum(v.nbytes for v in host.values()))
        if mesh is None:
            planes, ready = _stage_chunk(host, dev, uploads.get(dev))
            staged = planes, [] if ready is None else [(dev, ready)]
        else:
            staged = _stage_chunk_mesh(host, mesh, uploads)
        if empty:
            zero_staged[hi - lo] = staged
        return staged

    lane = None
    signed_bounds, signed_pending = [], {}
    if signed:
        from ba_tpu_torch.parallel.signing import SignAheadLane

        lane = SignAheadLane(B, seed=sign_seed, pool=pool, cache=cache, device=dev)
        cursor = start
        for nr in chunks:
            signed_bounds.append((cursor, cursor + nr))
            cursor += nr

    def stage_signed(i):
        """Window i's verdict planes: signed, with the next
        ``sign_coalesce`` - 1 windows not yet staged, in one lane pass;
        the extra planes wait here for their turn."""
        want = signed_bounds[i]
        if want not in signed_pending:
            group = [b for b in signed_bounds[i:i + sign_coalesce] if b not in signed_pending]
            signed_pending.update(zip(group, lane.stage_windows(group)))
        return signed_pending.pop(want)

    perf = time.perf_counter
    reg = obs.default_registry()
    sink_on = _metrics.default_sink().enabled
    inflight: collections.deque = collections.deque()
    retired = []
    max_in_flight = 0
    retires_before_drain = 0
    n_stalls = 0
    writes = []
    next_ckpt = start + checkpoint_every if checkpoint_every else None
    # The health instruments' readings, from host clocks the loop reads
    # anyway, go to the registry a batch at a time: at each health sample
    # and when the loop ends.
    lats, lags, occupancy, retired_rounds = [], [], [], [0]
    sampler = None
    if health_every is not None:
        sampler = obs.health.HealthSampler(reg, timeout_s=retire_timeout_s)
        sampler.prime()  # its first window is this campaign's, not the process's

    def flush_instruments():
        inst = _pipeline_instruments(reg)
        inst["lat"].record_many(lats)
        inst["lag"].record_many(lags)
        inst["occ"].record_many(occupancy)
        inst["disp"].inc(len(occupancy))
        inst["ret"].inc(len(lags))
        inst["rounds"].inc(retired_rounds[0])
        lats.clear()
        lags.clear()
        occupancy.clear()
        retired_rounds[0] = 0

    def write_checkpoint(round_cursor, carry):
        t0 = time.perf_counter()
        written = checkpoint_path.replace("{round}", str(round_cursor))
        layout = None
        if mesh is not None:  # gather on write: the canonical arrays, the writer's layout
            carry, layout = _mesh.gather_tree(carry, torch.device("cpu")), \
                _shard.shard_layout(mesh)
        nbytes = save_carry_checkpoint(
            written, CarryCheckpoint(*carry, round=round_cursor, shard_layout=layout,
                                     signed=signed, run_id=rid),
            rounds_total=rounds, **(checkpoint_meta or {}),
        )
        writes.append({"round": round_cursor, "bytes": nbytes,
                       "host_ms": (time.perf_counter() - t0) * 1e3})
        obs.instant("scenario_checkpoint", round=round_cursor, path=written)
        reg.counter("scenario_checkpoints_total").inc()
        _metrics.emit({"event": "scenario_checkpoint", "v": _metrics.SCHEMA_VERSION,
                       "round": round_cursor, "rounds": rounds,
                       "scenario": scenario is not None, "path": written, "bytes": nbytes,
                       "shard_layout": layout or {"data": 1}})
        if checkpoint_keep_last is not None:
            snapshot.prune_checkpoints(checkpoint_path, checkpoint_keep_last)
        if on_checkpoint is not None:
            on_checkpoint(round_cursor, written)

    def declare_stalled(d, lo, hi):
        # the watchdog's thread: observe and report only (a hung fetch is
        # not interruptible; recovery is the supervisor's)
        nonlocal n_stalls
        n_stalls += 1
        obs.instant("dispatch_stalled", dispatch=d, lo=lo, hi=hi, timeout_s=retire_timeout_s)
        reg.counter("pipeline_stalls_total").inc()
        if on_stall is not None:
            try:
                on_stall(d, retire_timeout_s)
            except Exception:
                pass  # a reporter never takes down the fetch it watches

    watchdog = None  # started with the loop, closed when it ends

    def retire():
        d, lo, hi, box, t_sub, ctx = inflight.popleft()
        with obs.timed_span("retire", dispatch=d) as wait:
            if watchdog is not None:
                watchdog.arm(d, lo, hi)
            try:
                host_ys = box.fetch() if exec_seam is None else exec_seam(
                    box.fetch, "retire", d, lo, hi)
            finally:
                if watchdog is not None:
                    watchdog.disarm()
        latency = perf() - t_sub
        lags.append(wait.elapsed_s)
        lats.append(latency)
        retired_rounds[0] += hi - lo
        if sink_on:
            _emit_flight_span(d, lo, hi, latency, wait.elapsed_s, rid, ctx, t_sub)
        if mesh is not None:  # the per-shard rows summed to the canonical blocks
            host_ys = _shard.reduce_host_ys(host_ys, scenario=scenario is not None,
                                            collect_decisions=collect_decisions,
                                            with_counters=with_counters)
        retired.append(host_ys)
        if on_rows is not None:  # before the checkpoint of the same retire
            on_rows(d, lo, hi, host_ys)
        if box.carry is not None:
            write_checkpoint(hi, box.carry)
        if on_event is not None:
            on_event("retire", d)

    # the dispatches' named signatures (the recompile explainer's axes),
    # made once a window length
    fn = ("scenario_megastep" if scenario is not None
          else "signed_megastep" if signed else "pipeline_megastep")
    sig_base = {"batch": B, "capacity": n, "m": m, "unroll": 1,
                "collect_decisions": collect_decisions, "signed": signed, "engine": engine}
    if signed:
        sig_base["collapsed"] = collapsed
    else:
        sig_base.update(max_liars=max_liars, counters=with_counters, data=n_shards,
                        scenario=scenario is not None)
    sigs: dict = {}

    def axes_of(nr):
        axes = sigs.get(nr)
        if axes is None:
            axes = sigs[nr] = dict(sig_base, rounds=nr)
        return axes

    # K1's artifact record on each signature's first dispatch (obs/cuda.py)
    introspect = engine == "cuda" and mesh is None and obs.cuda.enabled()

    with obs.trace.inject_scope(traceparent, mark="campaign"), \
            flight.run_scope(rid) as scope:
        lo = start
        staged = None
        if scenario is not None:
            staged = stage(start, start + chunks[0])
        elif signed:
            staged = stage_signed(0)
        try:
            if retire_timeout_s is not None:
                watchdog = _Watchdog(retire_timeout_s, declare_stalled)
            for d, nr in enumerate(chunks):
                hi = lo + nr
                if scenario is not None:
                    events, ready = staged
                    for ready_dev, event in ready:
                        torch.cuda.current_stream(ready_dev).wait_event(event)
                    call = functools.partial(
                        scen_fn, state, sched, strategy, counters, events, rounds=nr, m=m,
                        max_liars=max_liars, collect_decisions=collect_decisions)
                    args = (state, sched, strategy, counters, events)
                elif signed:
                    call = functools.partial(
                        signed_megastep, state, sched, counters, staged, rounds=nr, m=m,
                        collapsed=collapsed, collect_decisions=collect_decisions)
                    args = None
                else:
                    call = functools.partial(
                        plain_fn, state, sched, rounds=nr, m=m, max_liars=max_liars,
                        collect_decisions=collect_decisions, counters=counters)
                    args = (state, sched, counters)
                axes = axes_of(nr)
                probe = None
                with _dispatch_span(fn, axes, False, dispatch=d, rounds=nr) as phase, \
                        obs.cuda.annotate("megastep_dispatch", dispatch=d):
                    if phase == "compile" and introspect:
                        probe = obs.cuda.introspect(fn, axes, args, sources=K1_SOURCES,
                                                    device=dev)
                    out = call() if exec_seam is None else exec_seam(
                        _runs_once(call), "dispatch", d, lo, hi)
                if probe is not None:
                    probe.emit(out)
                t_sub = perf()
                if scenario is not None:
                    state, sched, strategy = out[:3]
                    ys = out[3:]
                    counters = ys[2][-1]
                else:
                    state, sched = out[:2]
                    ys = out[2:]
                    if with_counters:
                        counters = ys[-1][-1]
                carry = None
                if next_ckpt is not None and hi >= next_ckpt:
                    carry = (state, sched, counters, strategy)
                    next_ckpt = hi + checkpoint_every
                ctx = None
                if sink_on and obs.trace.current() is not None:
                    ctx = obs.trace.child_context()
                inflight.append((d, lo, hi, _Inflight(ys, carry), t_sub, ctx))
                occupancy.append(len(inflight))
                max_in_flight = max(max_in_flight, len(inflight))
                if on_event is not None:
                    on_event("dispatch", d)
                if scenario is not None and d + 1 < len(chunks):
                    staged = stage(hi, hi + chunks[d + 1])
                elif signed and d + 1 < len(chunks):
                    staged = stage_signed(d + 1)
                if host_work is not None:
                    host_work(d)
                if sampler is not None and (d + 1) % health_every == 0:
                    flush_instruments()
                    with obs.span("health_sample", dispatch=d):
                        sampler.sample(emit=True, dispatch=d)
                while len(inflight) > depth:
                    retire()
                    retires_before_drain += 1
                lo = hi
            while inflight:
                retire()
        finally:
            flush_instruments()
            if watchdog is not None:
                watchdog.close()
        if scope.owner:
            flight.emit_flight_summary(run_id=rid)

    carry = (state, sched, counters, strategy)
    result = {
        "histograms": np.concatenate([ys[0] for ys in retired]),
        "final_state": state,
        "final_schedule": sched,
        "stats": {
            "rounds": rounds - start,
            "start_round": start,
            "dispatches": len(chunks),
            "depth": depth,
            "rounds_per_dispatch": rounds_per_dispatch,
            "max_in_flight": max_in_flight,
            "retires_before_drain": retires_before_drain,
            "checkpoints": len(writes),
            "checkpoint_writes": writes,
            "stalls": n_stalls,
            "health_samples": sampler.samples if sampler is not None else 0,
            "engine": engine,
            "engine_fallback": reason if engine == "torch" else None,
            "run_id": rid,
            "signed": signed,
            "shards": n_shards,
            "carry_bytes_per_shard": _shard.per_shard_nbytes(carry),
            "plane_peak_bytes": plane_peak_bytes,
            "plane_peak_bytes_per_shard": plane_peak_bytes // n_shards,
            **_lane_stats(lane),
        },
    }
    if scenario is not None:
        names = SCENARIO_COUNTER_NAMES
        result["leaders"] = np.concatenate([ys[1] for ys in retired])
        rows = np.concatenate([ys[2] for ys in retired])
        result["final_strategy"] = strategy
        if collect_decisions:
            result["decisions"] = np.concatenate([ys[3] for ys in retired])
    else:
        names = SIGNED_COUNTER_NAMES if signed else COUNTER_NAMES
        rows = np.concatenate([ys[-1] for ys in retired]) if with_counters else None
        if collect_decisions:
            result["decisions"] = np.concatenate([ys[1] for ys in retired])
    if rows is not None:
        result["counters"] = {name: int(v) for name, v in zip(names, rows[-1])}
        result["counters_per_round"] = rows
        result["final_counters"] = counters
    return result


class _Watchdog:
    """One thread a sweep that calls ``fire(*args)`` when a wait armed
    with those args outlasts ``timeout_s``; the same semantics as a
    ``threading.Timer`` started at each :meth:`arm` and cancelled at
    each :meth:`disarm`, without a thread a wait.

    Deadlines only grow, so the thread sleeps until the latest deadline
    armed, whether its wait is still armed or not, and finds a newer wait
    when it wakes there: an arm wakes it only when no wait was armed in
    the last ``timeout_s``.  ``fire`` runs on the thread outside the
    lock, once a wait."""

    def __init__(self, timeout_s: float, fire):
        self._timeout_s = timeout_s
        self._fire = fire
        self._cv = threading.Condition(threading.Lock())
        self._armed = None  # (deadline, args) of the wait in progress
        self._horizon = 0.0  # the latest deadline armed
        self._idle = False  # the thread sleeps without a deadline
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="pipeline-retire-watchdog",
                                        daemon=True)
        self._thread.start()

    def arm(self, *args):
        with self._cv:
            self._armed = (time.monotonic() + self._timeout_s, args)
            self._horizon = self._armed[0]
            if self._idle:
                self._cv.notify()

    def disarm(self):
        with self._cv:
            self._armed = None

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def _run(self):
        with self._cv:
            while not self._closed:
                now = time.monotonic()
                armed = self._armed
                if armed is not None and armed[0] <= now:
                    args = armed[1]
                    self._armed = None
                    self._cv.release()
                    try:
                        self._fire(*args)
                    finally:
                        self._cv.acquire()
                    continue
                if self._horizon > now:
                    self._cv.wait(self._horizon - now)
                else:
                    self._idle = True
                    self._cv.wait()
                    self._idle = False


K1_SOURCES = ("megastep.cu",)  # the library a "cuda" megastep dispatch launches


@contextlib.contextmanager
def _dispatch_span(fn: str, axes: dict, warm: bool, **attrs):
    """A dispatch's span, yielding its phase: a warm dispatch (a warm
    entry of the graph cache) is a ``dispatch`` span with ``warm=True``
    and never touches the classifier, so the signature's first eager
    dispatch still reads as its compile; a cold one is classified by
    ``obs.compile_or_dispatch_span`` on ``(fn, axes)``."""
    if warm:
        with obs.span("dispatch", fn=fn, warm=True, **attrs):
            yield "dispatch"
    else:
        with obs.compile_or_dispatch_span(fn, axes=axes, fn=fn, **attrs) as phase:
            yield phase


class CarryConsumed(RuntimeError):
    """A dispatch's call was made again after its real call had begun.
    The megasteps update the carry in place, so a second run would start
    from a half-written carry; the error is fatal to the attempt (a
    supervisor resumes from a checkpoint)."""

    ba_tpu_fault = "fatal"


def _runs_once(call):
    """``call`` for an execution seam: the carry counts as consumed just
    before the real call runs, and a later invocation raises
    :class:`CarryConsumed` instead of running on it.  A seam's faults
    raised before it calls stay retryable in place."""
    began = []

    def once():
        if began:
            raise CarryConsumed("the dispatch's carry was consumed by a call that began "
                                "before; an in-place retry would read it half-written")
        began.append(True)
        return call()

    return once


def _lane_stats(lane) -> dict:
    """The sign-ahead lane's readings for a sweep's ``stats`` (zeros
    without a lane)."""
    if lane is None:
        return dict.fromkeys(("sign_ahead_s", "sign_pool_workers", "sign_pool_s",
                              "sign_cache_hits", "host_sign_s", "host_verify_s"), 0)
    return {"sign_ahead_s": round(lane.sign_ahead_s, 6), "sign_pool_workers": lane.pool_workers,
            "sign_pool_s": round(lane.pool_s, 6), "sign_cache_hits": lane.cache_hits,
            "host_sign_s": round(lane.sign_s, 6), "host_verify_s": round(lane.verify_s, 6)}


def _check_checkpointing(every, path, keep_last, meta, on_checkpoint) -> None:
    """The checkpoint options' eager checks, before any dispatch."""
    if every is not None and every < 1:
        raise ValueError(f"checkpoint_every={every} must be >= 1")
    if (path or on_checkpoint) and every is None:
        raise ValueError("checkpoint_path/on_checkpoint need checkpoint_every")
    if every is not None and path is None:
        # on_checkpoint alone is no sink: the hook gets (round, path), not the carry
        raise ValueError("checkpoint_every needs checkpoint_path")
    if keep_last is not None:
        if keep_last < 1:
            raise ValueError(f"checkpoint_keep_last={keep_last} must be >= 1")
        if every is None:
            raise ValueError("checkpoint_keep_last needs checkpoint_every")
        if "{round}" in os.path.dirname(path):
            raise ValueError("checkpoint_path cannot carry the {round} slot in its "
                             "directory component (retention scans one directory)")
        if "{round}" not in os.path.basename(path):
            raise ValueError("checkpoint_keep_last needs a {round}-templated checkpoint "
                             "FILENAME (the directory component cannot carry the slot)")
    if meta is not None:
        if every is None:
            raise ValueError("checkpoint_meta needs checkpoint_every")
        reserved = RESERVED_CARRY_META_KEYS & set(meta)
        if reserved:
            raise ValueError(f"checkpoint_meta key(s) {sorted(reserved)} are reserved "
                             f"for the carry header")


def scenario_sweep(  # ba-lint: donates(state)
        key: torch.Tensor | None, state: SimState | None, scenario, **kwargs):
    """Run a compiled scenario campaign: ``pipeline_sweep(...,
    scenario=block)`` with the round count read off the block (resuming:
    ``scenario_sweep(None, None, block, resume=ckpt)``)."""
    return pipeline_sweep(key, state, scenario.rounds, scenario=scenario, **kwargs)


def coalesced_sweep(  # ba-lint: donates(state)
    slot_keys,
    state: SimState,
    rounds: int,
    *,
    m: int = 1,
    max_liars: int | None = None,
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    scenario=None,
    initial_strategy=None,
    signed: bool = False,
    collapsed: bool = False,
    sign_seed: int = 0,
    pool=None,
    cache=None,
    exec_seam=None,
    on_retire=None,
    engine: str | None = None,
    device=None,
    run_id: str | None = None,
    executables=None,
):
    """Run a coalesced serving batch through the depth-k pipelined loop:
    B independent requests, one padded batch, bit-exact slot results.

    ``slot_keys`` holds one key per slot (key data ``[2]`` each, or a
    ``[B, 2]`` tensor).  Slot ``b``'s outputs are bit-identical to
    ``pipeline_sweep(slot_keys[b], <its B = 1 state>, rounds)`` (or
    ``scenario_sweep`` with its own ``[R, 1, n]`` planes) at equal padded
    capacity.  ``scenario`` is a ``ScenarioBlock`` or a dict of ``[rounds,
    B, n]`` planes (numpy arrays, or tensors), the slots' campaigns side
    by side along the batch; ``initial_strategy`` seeds its strategy
    plane (default all RANDOM).

    ``exec_seam(call, phase, dispatch, lo, hi)``, where given, makes each
    dispatch (``phase="dispatch"``) and each retire fetch
    (``phase="retire"``) by calling ``call()`` itself.
    ``on_retire(dispatch, lo, hi, host_ys)`` receives each retired
    window's host block ``(decisions, counter_rows[, leaders])``.
    ``device`` and ``engine`` follow :func:`resolve_engine`; the state
    moves to the device and is consumed.  At m != 1 every slot runs OM(m)
    by the EIG tree on the composed torch engine, ``max_liars`` capping
    its fused level's lying count.

    ``signed=True`` runs every slot through
    :func:`coalesced_signed_megastep` (per-slot SIGNED_COUNTER_NAMES
    blocks; ``collapsed`` picks the O(B n) relay; no scenario).  Every
    slot's own B = 1 run signs the tables of instance 0 under
    ``sign_seed``, so the slots' tables coincide: one B = 1 lane
    (``SignAheadLane(1, seed=sign_seed, pool=pool, cache=cache)``) stages
    all ``rounds`` up front, and each dispatch's ``[nr, 1, V]`` verdicts
    broadcast over the slots.

    ``executables`` is a warm-entry cache (``obs/graphcache.py``'s
    ``GraphCache``, anything with ``get(fn, axes)`` and ``evict``),
    consulted before each dispatch under the warmup lattice's axes: a
    captured CUDA graph replays the dispatch, an eager entry runs it as
    without the cache, and a miss runs it eagerly and counts in
    ``stats["warm_misses"]``.  A replay that raises evicts its entry and
    the same dispatch runs eagerly (``stats["graph_fallbacks"]``).
    Without ``executables`` the dispatches are exactly those above.

    The batch's run id is ``run_id`` (validated), else derived from the
    slot keys, the round count and the event planes' content
    (``obs/flight.py``): before the first dispatch when the sink is on,
    else while the loop dispatches (host planes, hashed on a thread) or
    after the last dispatch (keys alone, or planes on the card, whose
    fetch and hash at full width are a cost of their own: pass ``run_id``
    to skip them); it rides ``stats["run_id"]`` and one ``flight_span`` record a retired
    window when the sink is on (``utils/metrics.configure``), and no
    process-wide run scope is taken.
    Each dispatch and retire feeds the ``pipeline_*`` instruments of the
    default registry that the health sampler (``obs/health.py``) reads,
    from host clocks the loop reads anyway.

    Returns a dict: ``decisions`` [rounds, B] int8, ``majorities`` [B, n]
    (the final round's), ``counters`` [B, C] int32 (each slot's final
    block) and ``counter_names``, ``leaders`` [rounds, B] (scenario only),
    and ``stats``: ``rounds``, ``slots``, ``dispatches``, ``depth``,
    ``max_in_flight``, ``engine``, ``run_id``, ``request_path_compiles``
    (dispatches during which this thread built or first loaded a kernel
    library, ``ops/_build.thread_loads``), ``compile_s`` (their walls),
    ``retire_fetch_s``, ``warm_dispatches``, ``warm_misses`` and
    ``graph_fallbacks``.
    """
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    if rounds_per_dispatch < 1:
        raise ValueError(f"rounds_per_dispatch={rounds_per_dispatch} must be >= 1")
    if signed and scenario is not None:
        raise ValueError("signed cohorts cannot carry scenario planes (the signed "
                         "megastep has no mutating-round form)")
    if collapsed and not signed:
        raise ValueError("collapsed= is the signed relay dial; it needs signed=True")
    dev = resolve_device(device)
    engine = resolve_engine(engine, dev, m, signed)
    B, n = state.faulty.shape
    if len(slot_keys) != B:
        raise ValueError(f"{len(slot_keys)} slot key(s) for a batch of {B}")
    state = state.to(dev)
    sched = make_slot_key_schedule(slot_keys)
    key_material = sched.key_data
    sched = KeySchedule(sched.key_data.to(dev), sched.counter.to(dev))
    is_scenario = scenario is not None
    strategy = planes = None
    if is_scenario:
        planes = scenario if isinstance(scenario, dict) else (
            scenario.chunk(0, rounds) if hasattr(scenario, "chunk") else None)
        if planes is None or set(planes) != set(EVENT_PLANES):
            raise ValueError("scenario must be a ScenarioBlock or a plane dict")
        got = tuple(planes["kill"].shape)
        if got != (rounds, B, n):
            raise ValueError(f"scenario planes are {got}, batch wants {(rounds, B, n)}")
        if initial_strategy is None:
            strategy = torch.zeros((B, n), dtype=torch.int8, device=dev)
        else:
            strategy = torch.as_tensor(initial_strategy).to(dev, torch.int8).clone()
    elif initial_strategy is not None:
        raise ValueError("initial_strategy needs a scenario block")
    names = (SCENARIO_COUNTER_NAMES if is_scenario
             else SIGNED_COUNTER_NAMES if signed else COUNTER_NAMES)
    counters = torch.zeros((B, len(names)), dtype=torch.int32, device=dev)
    upload = torch.cuda.Stream(dev) if is_scenario and dev.type == "cuda" else None
    coalesced_fn, stage, lane = _engine_megasteps(engine)[2], None, None

    if is_scenario:
        def stage(lo, hi):
            chunk = {name: planes[name][lo:hi] for name in EVENT_PLANES}
            if all(isinstance(v, torch.Tensor) for v in chunk.values()):
                return {name: v.to(dev).contiguous() for name, v in chunk.items()}, None
            return _stage_chunk(chunk, dev, upload)
    elif signed:
        from ba_tpu_torch.parallel.signing import SignAheadLane

        lane = SignAheadLane(1, seed=sign_seed, pool=pool, cache=cache, device=dev)
        ok_planes = lane.stage(0, rounds)

        def stage(lo, hi):  # the B = 1 lane's verdicts, the same for every slot
            return ok_planes[lo:hi].expand(hi - lo, B, ok_planes.shape[-1]), None

        def coalesced_fn(state, sched, strategy, counters, verdicts, *, rounds, m, max_liars,
                         scenario):
            return coalesced_signed_megastep(state, sched, counters, verdicts, rounds=rounds,
                                             m=m, collapsed=collapsed)

    def identity_material():
        from ba_tpu_torch import convert

        material = ["coalesced", rounds, B, convert.key_data_to_numpy(key_material).tobytes()]
        if signed:
            material.append(f"signed:m={m}:collapsed={collapsed}")
        if is_scenario:
            material += [_plane_bytes(planes[name], name) for name in EVENT_PLANES]
        return material

    # The run id is needed before the first dispatch only when a flight
    # record will carry it.  Else host planes are hashed on a thread while
    # the loop dispatches (sha256 releases the interpreter lock), and keys
    # alone, or planes on the card, are hashed after the last dispatch.
    sink_on = _metrics.default_sink().enabled
    rid = hashing = None
    if run_id is not None or sink_on:
        rid = flight.resolve_run_id(run_id=run_id, material_fn=identity_material)
    elif is_scenario and not any(isinstance(planes[k], torch.Tensor)
                                 and planes[k].device.type != "cpu" for k in EVENT_PLANES):
        hasher = concurrent.futures.ThreadPoolExecutor(1)
        hashing = hasher.submit(flight.resolve_run_id, material_fn=identity_material)
        hasher.shutdown(wait=False)
    axes = {"batch": B, "capacity": n, "m": m, "max_liars": max_liars, "unroll": 1,
            "scenario": is_scenario, "signed": signed,
            "collapsed": collapsed if signed else False, "engine": engine}
    out = _coalesced_loop(
        state, sched, strategy, counters, stage, _chunks(rounds, rounds_per_dispatch), m=m,
        max_liars=max_liars, depth=depth, coalesced_fn=coalesced_fn, exec_seam=exec_seam,
        on_retire=on_retire, scenario=is_scenario, run_id=rid, executables=executables,
        axes=axes, sink_on=sink_on,
    )
    out["counter_names"] = list(names)
    out["stats"]["engine"] = engine
    if hashing is not None:
        rid = hashing.result()
    out["stats"]["run_id"] = rid or flight.resolve_run_id(material_fn=identity_material)
    if lane is not None:
        out["stats"].update(_lane_stats(lane))
    return out


def _plane_bytes(plane, name: str) -> memoryview:
    """An event plane's bytes as the JAX package's run id hashes them
    (its compiled block's dtype), without a copy when they are already
    so laid out on the host."""
    if isinstance(plane, torch.Tensor):
        # The caller's input, not a carry: hashed before the first
        # dispatch or after the last retire, never between dispatches.
        plane = plane.cpu().numpy()  # ba-lint: disable=BA101 (run-id material)
    dtype = np.bool_ if _PLANE_DTYPES[name] == torch.bool else np.int8
    return memoryview(np.ascontiguousarray(plane, dtype).reshape(-1).view(np.uint8))


_instruments: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _pipeline_instruments(reg) -> dict:
    """The dispatch loop's instruments, under the JAX package's names:
    the health sampler's depth-occupancy and retire-lag inputs.  Looked
    up once a registry (a registry never replaces an instrument)."""
    inst = _instruments.get(reg)
    if inst is None:
        inst = _instruments[reg] = {
            "lat": reg.histogram("pipeline_dispatch_latency_s"),
            "lag": reg.histogram("pipeline_retire_lag_s"),
            "occ": reg.histogram("pipeline_depth_occupancy", base=1.0, n_buckets=16),
            "disp": reg.counter("pipeline_dispatches_total"),
            "ret": reg.counter("pipeline_retires_total"),
            "rounds": reg.counter("pipeline_rounds_total"),
            "fallbacks": reg.counter("pipeline_graph_fallbacks_total"),
        }
    return inst


def _emit_flight_span(d, lo, hi, latency_s, lag_s, run_id, ctx, t_perf) -> None:
    """One ``flight_span`` record of a retired window, stamped with the
    batch's run id and the window's own context."""
    rec = {"event": "flight_span", "v": _metrics.SCHEMA_VERSION, "phase": "retire",
           "dispatch": d, "lo": lo, "hi": hi, "latency_s": round(latency_s, 6),
           "lag_s": round(lag_s, 6), "run_id": run_id, "t_perf": round(t_perf, 6)}
    if ctx is not None:
        rec["trace_id"], rec["span_id"] = ctx[0], ctx[1]
        if ctx[2] is not None:
            rec["parent_id"] = ctx[2]
    _metrics.emit(rec)


def _coalesced_loop(state, sched, strategy, counters, stage, chunks, *, m, max_liars, depth,
                    coalesced_fn, exec_seam, on_retire, scenario, run_id, executables, axes,
                    sink_on):
    """The coalesced batch's dispatch loop: :func:`pipeline_sweep`'s
    depth-k retire discipline (pinned copies behind a CUDA event, no other
    wait), each dispatch's planes (events, or a signed cohort's verdicts)
    staged just before it, its warm entry looked up first.  The health
    instruments' readings, from host clocks the loop reads anyway, are
    kept in lists and go to the registry once, when the loop ends: a
    serving batch is short, and the service samples its health between
    batches."""
    from ba_tpu_torch.ops import _build

    perf = time.perf_counter
    inflight: collections.deque = collections.deque()
    retired = []
    max_in_flight = 0
    tally = dict.fromkeys(("request_path_compiles", "warm_dispatches", "warm_misses",
                           "graph_fallbacks"), 0)
    compile_s = retire_fetch_s = 0.0
    lats, lags, occupancy, retired_rounds = [], [], [], [0]
    # this thread's library loads; the process-wide count is the cheap
    # per-dispatch check, the thread's count decides whose load it was
    loads, loads_total = _build.thread_loads(), _build.loads_total

    def retire():
        nonlocal retire_fetch_s
        d, lo, hi, box, t_sub, ctx = inflight.popleft()
        t0 = perf()
        host_ys = box.fetch() if exec_seam is None else exec_seam(
            box.fetch, "retire", d, lo, hi)
        t1 = perf()
        retire_fetch_s += t1 - t0
        lags.append(t1 - t0)
        lats.append(t1 - t_sub)
        retired_rounds[0] += hi - lo
        if sink_on:
            _emit_flight_span(d, lo, hi, t1 - t_sub, t1 - t0, run_id, ctx, t_sub)
        retired.append(host_ys)
        if on_retire is not None:
            on_retire(d, lo, hi, host_ys)

    lo = 0
    majorities = None
    windows: dict = {}  # the dispatches' signatures, one a window length
    try:
        for d, nr in enumerate(chunks):
            hi = lo + nr
            events = None
            if stage is not None:
                events, ready = stage(lo, hi)
                if ready is not None:
                    torch.cuda.current_stream(state.device).wait_event(ready)
            call = functools.partial(coalesced_fn, state, sched, strategy, counters, events,
                                     rounds=nr, m=m, max_liars=max_liars, scenario=scenario)
            win = windows.get(nr)
            if win is None:
                win = windows[nr] = dict(axes, rounds=nr)
            entry, fell_back = None, []
            if executables is not None:
                entry = executables.get("coalesced_megastep", win)
                if entry is None:
                    tally["warm_misses"] += 1
                elif entry.graph:
                    call = _graph_call(functools.partial(entry, state, sched, strategy,
                                                         counters, events),
                                       call, executables, win, fell_back)
            t_disp = perf()
            with _dispatch_span("coalesced_megastep", win, entry is not None, dispatch=d,
                                rounds=nr), obs.cuda.annotate("coalesced_dispatch", dispatch=d):
                out = call() if exec_seam is None else exec_seam(call, "dispatch", d, lo, hi)
            t_sub = perf()
            if _build.loads_total != loads_total:
                loads_total = _build.loads_total
                if _build.thread_loads() != loads:
                    loads = _build.thread_loads()
                    tally["request_path_compiles"] += 1
                    compile_s += t_sub - t_disp
            if entry is not None:
                tally["graph_fallbacks" if fell_back else "warm_dispatches"] += 1
            state, sched, strategy, majorities = out[:4]
            ys = out[4:]
            counters = ys[1][-1]  # the cumulative rows' last row continues
            ctx = None
            if sink_on and obs.trace.current() is not None:
                ctx = obs.trace.child_context()
            inflight.append((d, lo, hi, _Inflight(ys), t_sub, ctx))
            occupancy.append(len(inflight))
            max_in_flight = max(max_in_flight, len(inflight))
            while len(inflight) > depth:
                retire()
            lo = hi
        while inflight:
            retire()
    finally:
        inst = _pipeline_instruments(obs.default_registry())
        inst["lat"].record_many(lats)
        inst["lag"].record_many(lags)
        inst["occ"].record_many(occupancy)
        inst["disp"].inc(len(occupancy))
        inst["ret"].inc(len(lags))
        inst["rounds"].inc(retired_rounds[0])
        inst["fallbacks"].inc(tally["graph_fallbacks"])

    # After the last retire the queue is empty: these copies wait on nothing.
    result = {
        "decisions": np.concatenate([ys[0] for ys in retired]),
        "majorities": majorities.cpu().numpy(),  # ba-lint: disable=BA101 (drained)
        "counters": counters.cpu().numpy(),  # ba-lint: disable=BA101 (drained)
        "stats": {
            "rounds": lo,
            "slots": state.batch,
            "dispatches": len(chunks),
            "depth": depth,
            "max_in_flight": max_in_flight,
            **tally,
            "compile_s": round(compile_s, 6),
            "retire_fetch_s": round(retire_fetch_s, 6),
        },
    }
    if scenario:
        result["leaders"] = np.concatenate([ys[2] for ys in retired])
    return result


def _graph_call(replay, eager, executables, axes, fell_back):
    """A dispatch by its captured graph; a replay that raises evicts the
    entry and runs the same dispatch eagerly (noted in ``fell_back``)."""
    def call():
        try:
            return replay()
        except Exception:
            executables.evict("coalesced_megastep", axes)
            fell_back.append(axes)
            return eager()
    return call
