"""OM(1): one-round oral-message majority vote on tensors
(``ba_tpu/core/om.py``).

1. Round 1 (push): the leader sends its order to every general; a
   faulty leader lies per recipient (a coin, or its strategy's row).
   The leader itself always holds the true order.
2. Round 2 (pull): the ``[B, n, n]`` answer cube — ``answers[b, i, j]``
   is what responder ``j`` tells asker ``i``; faulty responders lie per
   asker, everyone answers itself truthfully.  Asker ``i`` counts
   responder ``j`` iff ``j`` is alive and not the leader; strict
   majority, tie -> UNDEFINED; the leader's majority is its order.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.quorum import majority_counts, quorum_decision, strict_majority
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, RETREAT
from ba_tpu_torch.scenario.strategies import lie_values


def _leader_mask(state: SimState) -> torch.Tensor:
    idx = torch.arange(state.n, device=state.device)
    return idx[None, :] == state.leader[:, None]


def round1_apply(state: SimState, coins: torch.Tensor, strategies=None) -> torch.Tensor:
    """What each general received from the leader, from pre-drawn coins
    ``[B, n]``: ``[B, n]`` int8."""
    n = state.n
    leader = state.leader.long()[:, None]
    if strategies is not None:
        leader_strategy = strategies.gather(1, leader)
        coins = lie_values(
            leader_strategy, coins, torch.arange(n, device=state.device)[None, :]
        )
    leader_faulty = state.faulty.gather(1, leader)
    order = state.order[:, None]
    received = torch.where(leader_faulty, coins, order)
    return torch.where(_leader_mask(state), order, received)


def round1_broadcast(key: torch.Tensor, state: SimState, strategies=None) -> torch.Tensor:
    """Round 1: a fair coin per recipient for a faulty leader's lies ->
    ``[B, n]`` int8.  One key ``[2]`` draws ``coin_bits(key, (B, n))``;
    keys ``[B, 2]`` draw ``(n,)`` a row, each row's own B = 1 round."""
    B, n = state.faulty.shape
    coins = rng.coin_bits(key, (B, n) if key.dim() == 1 else (n,))
    return round1_apply(state, coins, strategies)


def round2_apply(
    state: SimState, received: torch.Tensor, coins: torch.Tensor, strategies=None
) -> torch.Tensor:
    """The answer cube from pre-drawn coins ``[B, n, n]``."""
    n = state.n
    if strategies is not None:
        coins = lie_values(
            strategies[:, None, :],
            coins,
            torch.arange(n, device=state.device)[None, :, None],
        )
    answers = torch.where(state.faulty[:, None, :], coins, received[:, None, :])
    eye = torch.eye(n, dtype=torch.bool, device=state.device)[None]
    return torch.where(eye, received[:, None, :], answers)


def tally_majorities(
    state: SimState, received: torch.Tensor, answers: torch.Tensor
) -> torch.Tensor:
    """Per-general round-2 majority: ``[B, n]`` int8."""
    is_leader = _leader_mask(state)
    weight = state.alive[:, None, :] & ~is_leader[:, None, :]
    n_attack = ((answers == ATTACK) & weight).sum(-1)
    n_retreat = ((answers == RETREAT) & weight).sum(-1)
    majority = strict_majority(n_attack, n_retreat)
    return torch.where(is_leader, state.order[:, None], majority)


def om1_round_from_coins(state, coins1, coins2, strategies=None) -> torch.Tensor:
    """OM(1) from pre-drawn coin planes (``[B, n]`` and ``[B, n, n]``)."""
    received = round1_apply(state, coins1, strategies)
    answers = round2_apply(state, received, coins2, strategies)
    return tally_majorities(state, received, answers)


def om1_round(key: torch.Tensor, state: SimState, strategies=None) -> torch.Tensor:
    """Full OM(1) exchange under one key -> majorities ``[B, n]`` int8:
    ``split`` the key, round-1 coins from the first subkey, the cube's
    coins from the second."""
    B, n = state.faulty.shape
    k1, k2 = rng.split(key)
    return om1_round_from_coins(
        state, rng.coin_bits(k1, (B, n)), rng.coin_bits(k2, (B, n, n)), strategies
    )


def om1_agreement(key: torch.Tensor, state: SimState) -> dict:
    """One complete agreement round: majorities, then the quorum decision."""
    majorities = om1_round(key, state)
    n_attack, n_retreat, n_undefined = majority_counts(majorities, state.alive)
    decision, needed, total = quorum_decision(n_attack, n_retreat, n_undefined)
    return {
        "majorities": majorities,
        "decision": decision,
        "needed": needed,
        "total": total,
        "n_attack": n_attack,
        "n_retreat": n_retreat,
        "n_undefined": n_undefined,
    }
