"""The least work of a K2 dispatch (the fused signed-sweep step), counted
from its inputs whatever implements it.

Philox calls: with an honest leader every relay threshold is 0 or 256
and no draw matters; with a faulty one each alive recipient needs its
round-1 coin, one call a round, which for m <= 3 also serves its relay
draws (draws 0-3 share a block).  A call is 80 integer instructions (10
rounds of 2 IMAD.HI, 2 IMAD.LO, 2 three-way xors and 2 key adds).
Per round, m relay rounds and the choice over each live 32-general mask
word: 10 instructions a relay round and word (4 and/popc for the traitor
counts, 2 and/vote for the honest flags, 4 or/and updates), 8 for the
choice.  Bytes: seed, order, leader, faulty, alive and ok read once, each
decision written once.
"""

from __future__ import annotations

from portbench.work import peaks

PHILOX_OPS = 80
RELAY_WORD_OPS = 10
CHOICE_WORD_OPS = 8


def philox_calls(state: dict, rounds: int) -> int:
    lead = state["leader"].long()[:, None]
    faulty_leader = state["faulty"].gather(1, lead)[:, 0]
    recipients = state["alive"].sum(1) - state["alive"].gather(1, lead)[:, 0].long()
    return int((recipients * faulty_leader).sum()) * rounds


def dispatch_counts(state: dict, rounds: int, m: int) -> tuple[int, int]:
    """(integer instructions, bytes) one dispatch needs at least."""
    B, n = state["faulty"].shape
    words = int(((state["alive"].sum(1) + 31) // 32).sum())
    ops = (words * rounds * (RELAY_WORD_OPS * m + CHOICE_WORD_OPS)
           + philox_calls(state, rounds) * PHILOX_OPS)
    return ops, 4 + B * (1 + 4 + 2) + 2 * B * n + B * rounds


def bound_s(state: dict, rounds: int, m: int) -> tuple[float, str]:
    return peaks.bound_s(*dispatch_counts(state, rounds, m))
