"""BA401 fixture: dead imports in torch idioms (parsed, never run)."""

from __future__ import annotations

import os as operating_system  # expect: BA401
import threading
from functools import wraps  # expect: BA401

import numpy as np
import torch
import torch.nn.functional as F  # expect: BA401

from ba_tpu_torch.core.rng import split as ReExported
from ba_tpu_torch.core.types import ATTACK as _

__all__ = ["ReExported", "plane"]


def plane(x):
    # `torch` used through an attribute chain, `np` likewise.
    lock = threading.Lock()
    with lock:
        return torch.as_tensor(np.asarray(x))
