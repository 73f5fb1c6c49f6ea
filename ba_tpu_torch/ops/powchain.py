"""K8, point compression through the p - 2 inversion chain
(``csrc/powchain.cu``), and its plain torch version.

K8 replaces ``ba_tpu/ops/powchain.py::_inv_chain_kernel`` (the Pallas TPU
kernel, reached through ``pow_planes(z, P - 2)`` from
``ba_tpu/crypto/ed25519.py::compress``) and takes in the rest of
``compress`` that the reference leaves to XLA: x = X / Z, y = Y / Z and
the encoding, the canonical y with the low bit of x in bit 255.  Its
interface:

    points uint8 [N, 4, 32]  ->  encodings uint8 [N, 32]

:func:`compress` runs the plain version on a CPU tensor and launches K8
on a CUDA one, or raises; it keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.ops import _build

SOURCE = "powchain.cu"


def plain_compress(pts: torch.Tensor) -> torch.Tensor:
    """The plain version of K8: ``ed25519.compress_point`` on the limbs of
    the points, 1/Z through ``field.inv`` (the addition chain)."""
    return E.compress_point(E.decode_point(pts))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_compress
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def compress(pts: torch.Tensor) -> torch.Tensor:
    """Encode N points: uint8 [N, 4, 32] -> uint8 [N, 32]."""
    dev = pts.device
    if pts.dim() != 3 or tuple(pts.shape[1:]) != (4, 32):
        raise ValueError(f"pts must be [N, 4, 32], got {tuple(pts.shape)}")
    if dev.type == "cpu":
        return plain_compress(pts)
    if dev.type != "cuda":
        raise ValueError(f"the compress kernel runs on a CUDA device, not {dev}")
    n = pts.shape[0]
    _build.check_tensor(pts, "pts", torch.uint8, (n, 4, 32), dev)
    enc = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_compress(n, pts.data_ptr(), enc.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compress launch failed: CUDA error {err}")
    if n:
        compress.launches += 1
    return enc


compress.launches = 0


def reset_launches() -> None:
    compress.launches = 0
