"""Vectorized adversary strategies (``ba_tpu/scenario/strategies.py``:
``lie_table`` and ``lie_values`` for oral sends, ``send_gate`` for signed
ones).

Each general carries an int8 strategy id; a faulty sender's coin is
replaced through a precomputed lie table:

========================  ======  =======  =======
strategy                  known   even_v   odd_v
========================  ======  =======  =======
RANDOM / unknown ids      False   (coin)   (coin)
COLLUDE_ATTACK            True    ATTACK   ATTACK
COLLUDE_RETREAT           True    RETREAT  RETREAT
SILENT                    True    UNDEF    UNDEF
ADAPTIVE_SPLIT            True    ATTACK   RETREAT
========================  ======  =======  =======

Receiver parity (even/odd index) is ADAPTIVE_SPLIT's only receiver
dependence.  The command codes are pinned locally, as in the reference.
In a signed relay a traitor cannot forge, only withhold, so there each id
becomes a forward gate instead (:func:`send_gate`).
"""

from __future__ import annotations

import torch

_RETREAT = 0
_ATTACK = 1
_UNDEFINED = 2

# Ids are positions in ba_tpu_torch.scenario.spec.STRATEGY_NAMES.
RANDOM = 0
COLLUDE_ATTACK = 1
COLLUDE_RETREAT = 2
SILENT = 3
ADAPTIVE_SPLIT = 4


def lie_table(strategy: torch.Tensor, dtype):
    """``(known, even_v, odd_v)`` at strategy shape: what a sender with
    each id says to even- and odd-indexed receivers."""
    m1 = (strategy == COLLUDE_ATTACK).to(dtype)
    m3 = (strategy == SILENT).to(dtype)
    m4 = (strategy == ADAPTIVE_SPLIT).to(dtype)
    known = (m1 + (strategy == COLLUDE_RETREAT).to(dtype) + m3 + m4) > 0
    even_v = m1 * _ATTACK + m3 * _UNDEFINED + m4 * _ATTACK
    odd_v = even_v - m4 * (_ATTACK - _RETREAT)
    return known, even_v, odd_v


def lie_values(strategy, coins: torch.Tensor, receiver_index) -> torch.Tensor:
    """Per-message lie values for oral sends: the lie table where the
    sender's strategy is known, the coin otherwise.  ``strategy`` (the
    SENDER's id) and ``receiver_index`` broadcast against ``coins``."""
    known, even_v, odd_v = lie_table(strategy, coins.dtype)
    table_v = torch.where((receiver_index & 1) == 0, even_v, odd_v)
    return torch.where(known, table_v, coins)


def send_gate(strategy, coins: torch.Tensor, receiver_index, value_index) -> torch.Tensor:
    """Per-message forward gates for signed sends, the branch-free form
    (``ba_tpu/scenario/strategies.py:183``): ``coins`` is the RANDOM gate
    (bool), ``value_index`` the V-set axis (0 RETREAT, 1 ATTACK).
    COLLUDE_ATTACK forwards only ATTACK, COLLUDE_RETREAT only RETREAT,
    SILENT nothing, ADAPTIVE_SPLIT ATTACK to even receivers and RETREAT to
    odd ones; RANDOM and unknown ids keep the coin.  Whether the sender
    holds the value, and the chain-length bound, stay with the caller."""
    is_attack = value_index == 1
    m1 = strategy == COLLUDE_ATTACK
    m2 = strategy == COLLUDE_RETREAT
    m4 = strategy == ADAPTIVE_SPLIT
    known = m1 | m2 | (strategy == SILENT) | m4
    split = (receiver_index % 2 == 0) == is_attack
    return (coins & ~known) | (m1 & is_attack) | (m2 & ~is_attack) | (m4 & split)
