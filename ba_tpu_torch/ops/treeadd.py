"""K4, the fixed-base product [S]B (``csrc/treeadd.cu``), and its plain
torch version.

K4 replaces ``ba_tpu/ops/treeadd.py::_tree8_kernel`` (the Pallas TPU
kernel: the 64-way point fold of ``fold64_planes``, two levels of an
8-to-1 tree) and the one-hot gather of the window points, which the
reference runs in XLA (``ba_tpu/crypto/ed25519.py:174-192``).  Here the
kernel gathers from the window table itself, so its boundary, and the
plain version's, is the scalar:

    s uint8 [S, 32], table uint8 [64, 16, 4, 32]  ->  uint8 [S, 4, 32]

The table is ``crypto/ed25519.base_table(device)`` (T[w][d] = [d 16^w]B,
canonical encodings); the output point's coordinates are canonical.  Both
versions fold the 64 points in the reference's pairing, a balanced tree
of adjacent pairs, so they agree coordinate for coordinate; against the
reference's jnp fallback, which folds in order, the result is the same
group element in another projective representation (compare with
``point_eq``).

:func:`fixed_base_fold` runs the plain version on a CPU tensor and
launches K4 on a CUDA one, or raises; it keeps a plain integer
``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.ops import _build

SOURCE = "treeadd.cu"
WINDOWS = 64


def digits(s_enc: torch.Tensor) -> torch.Tensor:
    """The little-endian 4-bit digits of scalars uint8 [S, nbytes]: int64
    [S, 2 nbytes] (64 for the 32-byte scalars here)."""
    s = s_enc.to(torch.int64)
    return torch.stack([s & 0xF, s >> 4], dim=-1).reshape(s.shape[0], 2 * s.shape[1])


def plain_fixed_base_fold(s_enc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: gather [d_w 16^w]B for every window, then
    fold adjacent pairs level by level (32 + 16 + 8 + 4 + 2 + 1 additions)."""
    w = torch.arange(WINDOWS, device=s_enc.device)[None, :]
    entries = E.decode_point(table[w, digits(s_enc)])  # 4 x [S, 64, 22]
    while entries[0].shape[1] > 1:
        entries = E.point_add(tuple(c[:, 0::2] for c in entries),
                              tuple(c[:, 1::2] for c in entries))
    return E.encode_point(tuple(c[:, 0] for c in entries))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_fixed_base
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def fixed_base_fold(s_enc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[S]B for S scalars: s_enc uint8 [S, 32], the window table uint8
    [64, 16, 4, 32] on the same device -> uint8 [S, 4, 32]."""
    dev = s_enc.device
    if s_enc.dim() != 2 or s_enc.shape[1] != 32:
        raise ValueError(f"s_enc must be [S, 32], got {tuple(s_enc.shape)}")
    if dev.type == "cpu":
        return plain_fixed_base_fold(s_enc, table.to(dev))
    if dev.type != "cuda":
        raise ValueError(f"the fixed-base kernel runs on a CUDA device, not {dev}")
    n = s_enc.shape[0]
    _build.check_tensor(s_enc, "s_enc", torch.uint8, (n, 32), dev)
    _build.check_tensor(table, "table", torch.uint8, (WINDOWS, 16, 4, 32), dev)
    out = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_fixed_base(n, s_enc.data_ptr(), table.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fixed-base launch failed: CUDA error {err}")
    if n:
        fixed_base_fold.launches += 1
    return out


fixed_base_fold.launches = 0


def reset_launches() -> None:
    fixed_base_fold.launches = 0

