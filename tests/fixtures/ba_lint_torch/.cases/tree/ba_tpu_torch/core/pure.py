"""BA301 fixture: a clean device-tree module (negatives only).  It
imports a host-layer helper that instruments itself: the closure stops
at the host layer."""

import torch

from ba_tpu_torch.ops import _build
from ba_tpu_torch.utils.helpers import clamp


def quorum_threshold(n):
    _build.ensure("megastep.cu")
    return clamp(torch.as_tensor(n) // 3 + 1)
