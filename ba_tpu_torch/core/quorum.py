"""Quorum math: the 3f+1 decision rule, batched (``ba_tpu/core/quorum.py``).

- ``k = (total - 1) // 3``, ``needed = 2k + 1``, overridden to
  ``total - 1`` when ``total <= 3`` and to 1 when ``total == 1``;
- retreat is checked before attack, so a tie at the quorum level
  prefers retreat;
- zero voters never decide (UNDEFINED).
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    # A fill on the device: torch.tensor(value, device=...) would copy from
    # pageable host memory on every call, which can hold the host up.
    return torch.full((), value, dtype=COMMAND_DTYPE, device=like.device)


def strict_majority(n_attack: torch.Tensor, n_retreat: torch.Tensor) -> torch.Tensor:
    """Strict-majority vote, tie -> UNDEFINED (int8)."""
    return torch.where(
        n_attack > n_retreat,
        _const(ATTACK, n_attack),
        torch.where(
            n_retreat > n_attack,
            _const(RETREAT, n_attack),
            _const(UNDEFINED, n_attack),
        ),
    )


def majority_counts(majorities: torch.Tensor, alive: torch.Tensor):
    """(n_attack, n_retreat, n_undefined) over alive nodes: three [B] int32."""
    def count(code):
        return ((majorities == code) & alive).sum(-1, dtype=torch.int32)

    return count(ATTACK), count(RETREAT), count(UNDEFINED)


def quorum_threshold(total: torch.Tensor) -> torch.Tensor:
    """``needed`` as a function of ``total`` voters."""
    k = torch.div(total - 1, 3, rounding_mode="floor")
    needed = 2 * k + 1
    needed = torch.where(total <= 3, total - 1, needed)
    needed = torch.where(total == 1, torch.ones_like(needed), needed)
    return needed


def quorum_threshold_py(total: int) -> int:
    """:func:`quorum_threshold` on a Python int, for the REPL's shell."""
    k = (total - 1) // 3
    needed = 2 * k + 1
    if total <= 3:
        needed = total - 1
    if total == 1:
        needed = 1
    return needed


def quorum_decision(n_attack, n_retreat, n_undefined):
    """Final decision per instance: (decision [B] int8, needed, total)."""
    total = n_attack + n_retreat + n_undefined
    needed = quorum_threshold(total)
    decision = torch.where(
        needed <= n_retreat,
        _const(RETREAT, total),
        torch.where(
            needed <= n_attack, _const(ATTACK, total), _const(UNDEFINED, total)
        ),
    )
    decision = torch.where(total == 0, _const(UNDEFINED, total), decision)
    return decision, needed, total
