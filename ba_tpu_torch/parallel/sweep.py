"""Sweep states and one agreement round per instance with per-instance
keys (``ba_tpu/parallel/sweep.py``: ``make_sweep_state``,
``bucketed_sweep_states``, ``decision_histogram``, ``agreement_step``:
OM(1) on its coin-injected path, OM(m) through ``core/eig.py``;
``signed_agreement_step``, the signed SM(m) round of the signed engine;
``failover_sweep``, a kill-only campaign in one megastep; and
``sharded_sweep``, one round with the instances split over a mesh)."""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.eig import eig_round
from ba_tpu_torch.core.om import om1_round_from_coins, round1_broadcast
from ba_tpu_torch.core.quorum import majority_counts, quorum_decision
from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED
from ba_tpu_torch.scenario import strategies as _strategies


def make_sweep_state(
    key: torch.Tensor,
    batch: int,
    capacity: int,
    *,
    min_n: int | None = None,
    max_n: int | None = None,
    max_traitor_frac: float = 1 / 3,
    order=ATTACK,
) -> SimState:
    """A batch of random cluster configurations, bit-exact with jax's draws.

    Per instance: n uniform in [min_n, max_n] (alive = the first n
    slots), a traitor count uniform in [0, floor(n * max_traitor_frac)]
    (the product taken in float32, as jax takes an int32 array times a
    Python float), given to the lieutenants of lowest rank under random
    scores; the leader (slot 0) stays honest.  The state lies on the
    key's device.
    """
    if min_n is None:
        min_n = min(4, capacity)
    if max_n is None:
        max_n = capacity
    if not min_n <= max_n <= capacity:
        raise ValueError(f"need min_n <= max_n <= capacity, got "
                         f"{min_n}/{max_n}/{capacity}")
    dev = key.device
    k_n, k_m, k_perm = rng.split(key, 3).unbind(-2)
    idx = torch.arange(capacity, device=dev)[None, :]
    n = rng.randint(k_n, (batch,), min_n, max_n + 1)
    alive = idx < n[:, None]
    frac = torch.tensor(max_traitor_frac, dtype=torch.float32, device=dev)
    max_traitors = (n.to(torch.float32) * frac).to(torch.int32)
    n_traitors = rng.randint(k_m, (batch,), 0, max_traitors + 1)
    scores = rng.uniform(k_perm, (batch, capacity))
    scores = torch.where(alive & (idx > 0), scores, torch.inf)
    order_ids = torch.sort(scores, dim=-1, stable=True).indices
    ranks = torch.sort(order_ids, dim=-1, stable=True).indices
    return SimState(
        order=torch.full((batch,), order, dtype=COMMAND_DTYPE, device=dev),
        leader=torch.zeros((batch,), dtype=torch.int32, device=dev),
        faulty=ranks < n_traitors[:, None],
        alive=alive,
        ids=torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
        .expand(batch, capacity).clone(),
    )


def bucketed_sweep_states(
    key: torch.Tensor,
    batch: int,
    capacity: int,
    n_buckets: int = 2,
    *,
    min_n: int = 4,
    max_traitor_frac: float = 1 / 3,
    order=ATTACK,
) -> list[SimState]:
    """Equal-count, equal-width cluster-size buckets, each padded only to
    its own upper edge rounded up to 128 (capped at ``capacity``).
    Bucket k draws from ``fold_in(key, k)``; the remainder instances go
    to the last bucket."""
    if n_buckets < 1 or n_buckets > capacity:
        raise ValueError(f"n_buckets={n_buckets} out of range")
    if capacity // n_buckets < min_n:
        raise ValueError(
            f"capacity/n_buckets = {capacity}/{n_buckets} puts the first "
            f"bucket's upper edge below min_n={min_n}; use fewer buckets"
        )
    per = batch // n_buckets
    states = []
    lo = min_n
    for k in range(n_buckets):
        hi = capacity * (k + 1) // n_buckets
        cap_k = -(-hi // 128) * 128
        bk = per if k < n_buckets - 1 else batch - per * (n_buckets - 1)
        states.append(make_sweep_state(
            rng.fold_in(key, k), bk, min(cap_k, capacity), min_n=lo, max_n=hi,
            max_traitor_frac=max_traitor_frac, order=order,
        ))
        lo = hi + 1
    return states


def decision_histogram(decision: torch.Tensor) -> torch.Tensor:
    """[B] decisions -> 3-bin [retreat, attack, undefined] int32 counts."""
    return torch.stack(
        [(decision == code).sum(dtype=torch.int32) for code in (RETREAT, ATTACK, UNDEFINED)]
    )


def agreement_step(keys: torch.Tensor, state: SimState, m: int = 1,
                   max_liars: int | None = None, strategies=None) -> dict:
    """One agreement round per instance; ``keys`` is ``[B, 2]`` key data.

    Instance ``b`` draws exactly what a B = 1 round under its own key
    draws.  At m = 1 it splits its key into (round-1, cube) subkeys;
    without strategies the coins unpack through ``coin_bits``, with a
    strategies plane (``[B, n]`` int8) through ``coin_words`` +
    ``unpack_coin_words`` — the same bits either way, as in the
    reference.  Any other m runs ``eig_round`` with one key a row
    (OM(m) by the EIG tree, fused at m >= 2 unless strategies are given);
    ``max_liars``, the known traitor cap, sizes its fused level's draw
    and clamps its lying count, so derive it from the state.

    Inside ``strategies.chain_impl()`` OM(1) takes the per-instance round
    (``ba_tpu/parallel/sweep.py:194``): each row draws as its own B = 1
    ``om1_round`` does, through ``coin_bits`` with or without strategies,
    and the legacy select chains choose the lies.  The same bits.
    """
    n = state.n
    if m != 1:
        majorities = eig_round(keys, state, m, max_liars, strategies)
    else:
        sub = rng.split(keys)
        k1, k2 = sub[:, 0], sub[:, 1]
        if strategies is None or _strategies.chain_active():
            coins1 = rng.coin_bits(k1, (n,))
            coins2 = rng.coin_bits(k2, (n, n))
        else:
            coins1 = rng.unpack_coin_words(rng.coin_words(k1, n), (n,))
            coins2 = rng.unpack_coin_words(rng.coin_words(k2, n * n), (n, n))
        majorities = om1_round_from_coins(state, coins1, coins2, strategies)
    n_attack, n_retreat, n_undefined = majority_counts(majorities, state.alive)
    decision, needed, total = quorum_decision(n_attack, n_retreat, n_undefined)
    return {
        "majorities": majorities,
        "decision": decision,
        "needed": needed,
        "total": total,
        "histogram": decision_histogram(decision),
    }


def signed_agreement_step(keys: torch.Tensor, state: SimState, ok: torch.Tensor,
                          m: int = 1, collapsed: bool = False) -> dict:
    """One signed SM(m) round per instance with per-instance keys
    (``ba_tpu/parallel/sweep.py:321``); ``keys`` is ``[B, 2]`` key data.

    Per instance, as a B = 1 round under its own key: split the key, the
    commander's round-1 broadcast under the first half, each received
    value gated on its table verdict (``ok`` [B, 2] bool, the round's
    per-(instance, value) verdicts, by the reference's V = 2 select of
    ``sig_valid_from_tables``; any other V raises), then ``sm_round``
    under the second half: m relay rounds, exact, or collapsed with
    ``collapsed``, and the quorum.  Returns the :func:`agreement_step` dict plus ``received``
    [B, n], the round-1 values the signed counters read.
    """
    from ba_tpu_torch.core.sm import sm_round

    if ok.shape[-1] != 2:
        raise ValueError(f"ok {tuple(ok.shape)}: the signed round takes V = 2 verdict tables")
    k1, k2 = rng.split(keys).unbind(-2)
    received = round1_broadcast(k1, state)
    sig_valid = torch.where(received == 1, ok[:, 1:2], ok[:, 0:1])
    majorities = sm_round(k2, state, m, sig_valid=sig_valid, received=received,
                          collapsed=collapsed)
    n_attack, n_retreat, n_undefined = majority_counts(majorities, state.alive)
    decision, needed, total = quorum_decision(n_attack, n_retreat, n_undefined)
    return {
        "majorities": majorities,
        "decision": decision,
        "needed": needed,
        "total": total,
        "histogram": decision_histogram(decision),
        "received": received,
    }


def failover_sweep(
    key: torch.Tensor,
    state: SimState,
    kill_schedule,
    m: int = 1,
    max_liars: int | None = None,
    *,
    engine: str | None = None,
    device=None,
) -> dict:
    """Multi-round sweep with leader failover: each round's kills, then
    instances whose leader died re-elect the lowest alive id, then the
    agreement round with every general's strategy RANDOM.

    A thin wrapper of the engine's scenario megastep over a kill-only
    campaign (``revive`` all False, ``set_faulty`` / ``set_strategy`` all
    -1), in one dispatch of R rounds: at m = 1 on the card one launch of
    K1's scenario mode; at other m the composed torch engine (OM(m) by
    the EIG tree).  ``engine`` and ``device`` follow ``pipeline_sweep``'s
    rule; the caller's state is left as it was.

    ``kill_schedule`` [R, B, n] bool (numpy or a tensor): who dies before
    each of the R rounds.  Returns ``leaders`` [R, B] int32 (after each
    round's election), ``decisions`` [R, B] int8, ``histograms`` [R, 3]
    int32 and ``final_state``, all on the device.
    """
    # pipeline.py imports this module for agreement_step: resolve it late
    from ba_tpu_torch.parallel import pipeline as _pipeline

    dev = resolve_device(device)
    engine = _pipeline.resolve_engine(engine, dev, m)
    kills = torch.as_tensor(kill_schedule).to(dev, torch.bool).contiguous()
    R = kills.shape[0]
    B, n = state.faulty.shape
    if R < 1 or tuple(kills.shape) != (R, B, n):
        raise ValueError(f"kill_schedule is {tuple(kills.shape)}, want [R >= 1, {B}, {n}]")
    keep = torch.full((R, B, n), -1, dtype=torch.int8, device=dev)
    events = {"kill": kills, "revive": torch.zeros_like(kills),
              "set_faulty": keep, "set_strategy": keep.clone()}
    scen_fn = _pipeline._engine_megasteps(engine)[1]
    out = scen_fn(
        _pipeline.fresh_copy(state, dev), _pipeline.make_key_schedule(key.to(dev)),
        torch.zeros((B, n), dtype=torch.int8, device=dev),  # every general RANDOM
        _pipeline.scenario_counters_init(dev), events,
        rounds=R, m=m, max_liars=max_liars, collect_decisions=True,
    )
    return {"leaders": out[4], "decisions": out[6], "histograms": out[3],
            "final_state": out[0]}


def sharded_sweep(mesh, key: torch.Tensor, state: SimState, m: int = 1) -> dict:
    """One agreement round per instance, the instances split over the
    mesh's "data" axis (``ba_tpu/parallel/sweep.py:386``).

    The key splits into B per-instance keys globally, the keys and the
    state shard with the batch (``put_global``: every process passes the
    full value), each shard runs :func:`agreement_step` on its rows, and
    the 3-bin histogram is summed over "data" (the one collective; across
    processes through the mesh's group).  Every per-instance output comes
    back as a Sharded value of its global shape, the histogram replicated.
    Bit-exact with the unsharded step: instance b draws from its own key.
    """
    from ba_tpu_torch.parallel import mesh as _mesh

    state = _mesh.gather_tree(state)
    keys = rng.split(key.to(state.device), state.batch)
    row = _mesh.P("data")

    def local(keys, st):
        out = agreement_step(keys, st, m=m)
        out["histogram"] = _mesh.psum(out["histogram"], "data")
        return out

    specs = {"majorities": row, "decision": row, "needed": row, "total": row,
             "histogram": _mesh.P()}
    return _mesh.shard_map(local, mesh, specs)(_mesh.put_global(mesh, keys, row),
                                              _mesh.shard_state(mesh, state))
