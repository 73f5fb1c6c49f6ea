"""Cluster states of a sweep, drawn on the device.

The draws of the port's ``make_sweep_state`` / ``bucketed_sweep_states``:
per instance n generals uniform in [min_n, max_n] (alive = the first n
slots), a traitor count uniform in [0, floor(n * frac)] (the product in
float32), leader 0, the order ATTACK; buckets padded to their upper edge
rounded up to 128.

One change: the traitors go to the alive generals of lowest rank under
random scores, the commander (slot 0) among them, where the port's state
keeps the commander honest.  OM(m) and SM(m) tolerate any m of the n
generals as traitors, the commander included (Lamport, Shostak and Pease
1982, sections 3 and 4), and the source program's commander equivocates
when it is faulty (``ba.py`` ``Process.order``).  So an instance's
commander is a traitor with probability t/n.

The configurations draw their clusters from a key of their own
(``instances_seed``), not from ``--seed``: every run serves the same
deployment, and a seed changes the coins, keys, kill planes and samples.

A state is a dict of tensors: ``order`` [B] int8, ``leader`` [B] int32,
``faulty`` / ``alive`` [B, n] bool, ``ids`` [B, n] int32 (1..n).
"""

from __future__ import annotations

import torch

from portbench.reference import threefry as tf

ATTACK = 1
FIELDS = ("order", "leader", "faulty", "alive", "ids")


def sweep_state(key: torch.Tensor, batch: int, capacity: int, *, min_n: int, max_n: int,
                max_traitor_frac: float = 1 / 3) -> dict:
    """One batch of clusters."""
    if not 1 <= min_n <= max_n <= capacity:
        raise ValueError(f"need 1 <= min_n <= max_n <= capacity, got {min_n}/{max_n}/{capacity}")
    dev = key.device
    k_n, k_m, k_perm = tf.split(key, 3).unbind(-2)
    idx = torch.arange(capacity, device=dev)[None, :]
    n = tf.randint(k_n, (batch,), min_n, max_n + 1)
    alive = idx < n[:, None]
    frac = torch.tensor(max_traitor_frac, dtype=torch.float32, device=dev)
    max_traitors = (n.to(torch.float32) * frac).to(torch.int32)
    n_traitors = tf.randint(k_m, (batch,), 0, max_traitors + 1)
    scores = tf.uniform(k_perm, (batch, capacity))
    scores = torch.where(alive, scores, torch.inf)
    order_ids = torch.sort(scores, dim=-1, stable=True).indices
    ranks = torch.sort(order_ids, dim=-1, stable=True).indices
    return {
        "order": torch.full((batch,), ATTACK, dtype=torch.int8, device=dev),
        "leader": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "faulty": ranks < n_traitors[:, None],
        "alive": alive,
        "ids": torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
        .expand(batch, capacity).clone(),
    }


def bucketed_states(key: torch.Tensor, batch: int, capacity: int, n_buckets: int, *,
                    min_n: int, max_traitor_frac: float = 1 / 3) -> list[dict]:
    """``bucketed_sweep_states``' buckets: equal-count, equal-width size
    buckets, bucket k drawn from ``fold_in(key, k)``, padded to its upper
    edge rounded up to 128 (capped at ``capacity``); the remainder
    instances go to the last bucket."""
    per = batch // n_buckets
    states, lo = [], min_n
    for k in range(n_buckets):
        hi = capacity * (k + 1) // n_buckets
        cap_k = min(-(-hi // 128) * 128, capacity)
        bk = per if k < n_buckets - 1 else batch - per * (n_buckets - 1)
        states.append(sweep_state(tf.fold_in(key, k), bk, cap_k, min_n=lo, max_n=hi,
                                  max_traitor_frac=max_traitor_frac))
        lo = hi + 1
    return states


def rows(state: dict, index) -> dict:
    """The state of the instances ``index`` (a tensor of row numbers)."""
    return {name: state[name][index] for name in FIELDS}


def spread_rows(size: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """``k`` row numbers of ``[0, size)``, one drawn in each of ``k``
    equal strata, so a sample reaches every part of a launch's grid."""
    k = min(k, size)
    edges = torch.arange(k + 1) * size // k
    return edges[:-1] + (torch.rand(k, generator=gen) * (edges[1:] - edges[:-1])).long()


def pick(candidates: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """Up to ``k`` of ``candidates`` (a 1-D tensor), drawn without repeats."""
    return candidates[torch.randperm(len(candidates), generator=gen)[:k]]
