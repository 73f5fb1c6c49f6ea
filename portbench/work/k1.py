"""The least work of a K1 dispatch (the OM(1) megastep kernel), counted
from its inputs whatever implements it.

Operations: per instance-round, the coins that decide a vote -- one per
recipient of a faulty coin-drawing leader, one per (counted asker,
counted coin-drawing responder other than itself) -- take at least
coins / 32 threefry words, plus four words of round keys; a threefry
word is 80 integer instructions (60 mix, 15 key injection, 4 set-up, 1
output xor).  Each coin vote is one tally step, and each counted general
one more.  Bytes: each input read once and each output written once.
"""

from __future__ import annotations

import torch

from portbench.reference.om1 import elect_lowest_id
from portbench.work import peaks

THREEFRY_OPS = 80


def work_counts(state: dict, rounds: int, kills: torch.Tensor | None = None) -> tuple[int, int]:
    """(threefry words, tally steps) that ``rounds`` rounds of these inputs
    need at least; ``kills`` [R, B, n] applies a failover campaign's
    deaths and elections before each round.  Every strategy is RANDOM
    (a coin-drawing one)."""
    alive, faulty, leader = state["alive"], state["faulty"], state["leader"]
    idx = torch.arange(faulty.shape[1], device=faulty.device)[None, :]
    words = steps = 0
    for r in range(rounds):
        if kills is not None:
            alive = alive & ~kills[r]
            leader_alive = alive.gather(1, leader.long()[:, None])[:, 0]
            leader = torch.where(leader_alive, leader, elect_lowest_id(state["ids"], alive))
        counted = alive & (idx != leader[:, None])
        a = counted.sum(1)
        u = (counted & faulty).sum(1)
        lcoin = faulty.gather(1, leader.long()[:, None])[:, 0]
        coins1 = torch.where(lcoin, a, torch.zeros_like(a))
        coins2 = u * (a - 1).clamp(min=0)
        words += int(((coins1 + 31) // 32 + (coins2 + 31) // 32 + 4).sum())
        steps += int((coins2 + a).sum())
    return words, steps


def dispatch_bytes(B: int, n: int, rounds: int, scenario: bool) -> int:
    """Plain: order, leader, faulty, alive, ids, key, counter and counters
    read; histograms, decisions and counter rows written.  Scenario: also
    the strategy plane and four event planes read, the state planes,
    strategy and leaders written."""
    if scenario:
        return (B * 5 + B * n * 7 + rounds * B * n * 4 + 16 + 4 + 20
                + B * 4 + B * n * 3 + rounds * B * 5 + rounds * (12 + 20))
    return B * 5 + B * n * 6 + 16 + 4 + 12 + rounds * (12 + B + 12)


def bound_s(state: dict, rounds: int, kills: torch.Tensor | None = None) -> tuple[float, str]:
    """(least seconds of one dispatch on the card, what bounds it)."""
    words, steps = work_counts(state, rounds, kills)
    B, n = state["faulty"].shape
    return peaks.bound_s(words * THREEFRY_OPS + steps,
                         dispatch_bytes(B, n, rounds, kills is not None))
