"""K6, a 512-bit value mod L (``csrc/modl.cu``), and its plain torch
version.

K6 replaces ``ba_tpu/ops/modl.py::_modl_kernel`` (the Pallas TPU kernel,
through ``reduce_mod_l_planes``): each lane's 64 bytes read as sixteen
32-bit words by four 16-byte loads and reduced by Barrett's method in
words (``csrc/modl.cuh``), byte-identical to ``crypto/scalar.reduce_mod_l``
for every input (a result in [0, L) is unique).  The signer reduces its
S = k * a + r with it, ``verify_rlc`` its products and sums.  Interface:

    h uint8 [S, 64] little-endian, base 16-byte aligned  ->  uint8 [S, 32]

:func:`reduce_mod_l_planes` runs the plain version on a CPU tensor and
launches K6 on a CUDA one, or raises (also on a base that is not 16-byte
aligned); it keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto.scalar import reduce_mod_l as plain_reduce_mod_l
from ba_tpu_torch.ops import _build

SOURCE = "modl.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_modl
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def reduce_mod_l_planes(h: torch.Tensor) -> torch.Tensor:
    """``h mod L`` a lane: uint8 [S, 64] -> uint8 [S, 32], little endian."""
    dev = h.device
    if h.dim() != 2 or h.shape[1] != 64:
        raise ValueError(f"h must be [S, 64], got {tuple(h.shape)}")
    if dev.type == "cpu":
        return plain_reduce_mod_l(h)
    if dev.type != "cuda":
        raise ValueError(f"the mod-L kernel runs on a CUDA device, not {dev}")
    S = h.shape[0]
    _build.check_tensor(h, "h", torch.uint8, (S, 64), dev)
    _build.check_aligned(h, "h")
    out = torch.empty((S, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_modl(S, h.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mod L launch failed: CUDA error {err}")
    if S:
        reduce_mod_l_planes.launches += 1
    return out


reduce_mod_l_planes.launches = 0


def reset_launches() -> None:
    reduce_mod_l_planes.launches = 0
