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

The legacy select chains (:func:`lie_values_chain`,
:func:`send_gate_chain`, ``ba_tpu/scenario/strategies.py:230``, ``:245``)
are the formulation before the lie table: a nested select a strategy
row.  They give the same bits for coins in {0, 1} and any int8 id.
Inside :func:`chain_impl` the torch engine takes them, and the
per-instance OM(1) round with them (``parallel/sweep.agreement_step``);
K1 has one formulation, the lie table (``lie_value`` in
``ops/csrc/megastep.cu``), and ignores the flag.
"""

from __future__ import annotations

import contextlib

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

# Process-wide, as the reference's trace-time flag: set only by
# chain_impl() (the reference's BA_TPU_STRATEGY_CHAIN=1).
_impl_chain = False


@contextlib.contextmanager
def chain_impl(enabled: bool = True):
    """Run the legacy strategy formulation inside this context
    (``ba_tpu/scenario/strategies.py:94``): the select chains here and
    the per-instance round of ``parallel.sweep.agreement_step``.  The
    torch engine reads the flag at each call, so there is no cache to
    clear; K1 does not read it."""
    global _impl_chain
    prev = _impl_chain
    _impl_chain = enabled
    try:
        yield
    finally:
        _impl_chain = prev


def chain_active() -> bool:
    return _impl_chain


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
    if _impl_chain:
        return lie_values_chain(strategy, coins, receiver_index)
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
    if _impl_chain:
        return send_gate_chain(strategy, coins, receiver_index, value_index)
    is_attack = value_index == 1
    m1 = strategy == COLLUDE_ATTACK
    m2 = strategy == COLLUDE_RETREAT
    m4 = strategy == ADAPTIVE_SPLIT
    known = m1 | m2 | (strategy == SILENT) | m4
    split = (receiver_index % 2 == 0) == is_attack
    return (coins & ~known) | (m1 & is_attack) | (m2 & ~is_attack) | (m4 & split)


# -- the legacy select chains --------------------------------------------------


def lie_values_chain(strategy, coins: torch.Tensor, receiver_index) -> torch.Tensor:
    """:func:`lie_values` as a nested select a strategy row
    (``ba_tpu/scenario/strategies.py:230``); the same bits."""
    def const(v):
        return torch.tensor(v, dtype=coins.dtype, device=coins.device)

    attack, retreat, undefined = const(_ATTACK), const(_RETREAT), const(_UNDEFINED)
    split = torch.where((receiver_index & 1) == 0, attack, retreat)
    v = coins
    v = torch.where(strategy == COLLUDE_ATTACK, attack, v)
    v = torch.where(strategy == COLLUDE_RETREAT, retreat, v)
    v = torch.where(strategy == SILENT, undefined, v)
    return torch.where(strategy == ADAPTIVE_SPLIT, split, v)


def send_gate_chain(strategy, coins: torch.Tensor, receiver_index,
                    value_index) -> torch.Tensor:
    """:func:`send_gate` as a nested select a strategy row
    (``ba_tpu/scenario/strategies.py:245``); the same bits."""
    is_attack = value_index == 1
    split = (receiver_index % 2 == 0) == is_attack
    never = torch.zeros((), dtype=torch.bool, device=coins.device)
    g = coins
    g = torch.where(strategy == COLLUDE_ATTACK, is_attack, g)
    g = torch.where(strategy == COLLUDE_RETREAT, ~is_attack, g)
    g = torch.where(strategy == SILENT, never, g)
    return torch.where(strategy == ADAPTIVE_SPLIT, split, g)
