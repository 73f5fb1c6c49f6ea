"""Command encoding shared by the whole port (``ba_tpu/core/types.py``).

Commands are int8 lanes: RETREAT = 0, ATTACK = 1, UNDEFINED = 2 (the
last only ever produced by majority ties or a silent sender, never a
real order).
"""

from __future__ import annotations

import torch

COMMAND_DTYPE = torch.int8

RETREAT = 0
ATTACK = 1
UNDEFINED = 2

COMMAND_NAMES = ("retreat", "attack", "undefined")  # by code: the REPL's majority words


def command_from_name(name: str) -> int:
    """Map a command string to its int8 code: anything that is not
    exactly "attack" counts as retreat (the reference's tally rule)."""
    return ATTACK if name == "attack" else RETREAT

