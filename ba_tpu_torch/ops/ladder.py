"""K3, the verification tail (``csrc/window_verify.cu``), and its plain
torch version.

K3 replaces ``ba_tpu/ops/ladder.py::_window_verify_kernel`` (the Pallas
TPU kernel, the verify-fused form of the 4-bit window multiply): per lane
[h]A by 64 windows, most significant first, of four doublings and one
addition from the 16-entry table of [j]A; then R + [h]A and the
cross-multiplied equality with [S]B.  Its interface:

    a, r uint8 [S, 4, 32], h uint8 [S, 32], left uint8 [S, 4, 32]  ->  bool [S]

Points are canonical encodings (``crypto/ed25519.encode_point``); ``h``
is the little-endian scalar whose nibble w is the digit of window w, the
reference's ``(word >> 4 * (w & 7)) & 15`` of the packed bits.  The
siblings ``_window_kernel`` and ``_ladder_kernel`` are not ported yet.

:func:`window_verify` runs the plain version on a CPU tensor and launches
K3 on a CUDA one, or raises; it keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build
from ba_tpu_torch.ops.treeadd import digits

SOURCE = "window_verify.cu"
WINDOWS = 64


def plain_window_verify(a: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                        left: torch.Tensor) -> torch.Tensor:
    """The plain version of K3, the kernel's steps batched over lanes."""
    S = a.shape[0]
    dev = a.device
    point = E.decode_point(a)
    table = [E.identity((S,), dev), point]
    for _ in range(2, 16):
        table.append(E.point_add(table[-1], point))
    table = tuple(torch.stack([t[c].expand(S, F.LIMBS) for t in table], dim=1)
                  for c in range(4))  # 4 x [S, 16, 22]
    lanes = torch.arange(S, device=dev)
    dig = digits(h)
    acc = E.identity((S,), dev)
    for w in range(WINDOWS - 1, -1, -1):
        for k in range(4):
            acc = E.point_dbl(acc, with_t=k == 3)
        acc = E.point_add(acc, tuple(c[lanes, dig[:, w]] for c in table))
    xr, yr, zr, _ = E.point_add(E.decode_point(r), acc)
    xl, yl, zl, _ = E.decode_point(left)
    return F.eq(F.mul(xl, zr), F.mul(xr, zl)) & F.eq(F.mul(yl, zr), F.mul(yr, zl))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_window_verify
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return lib


def window_verify(a: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                  left: torch.Tensor) -> torch.Tensor:
    """``left == r + [h]a`` per lane -> bool [S]."""
    dev = a.device
    if a.dim() != 3 or tuple(a.shape[1:]) != (4, 32):
        raise ValueError(f"a must be [S, 4, 32], got {tuple(a.shape)}")
    if dev.type == "cpu":
        return plain_window_verify(a, h, r, left)
    if dev.type != "cuda":
        raise ValueError(f"the window-verify kernel runs on a CUDA device, not {dev}")
    n = a.shape[0]
    for name, t, shape in (("a", a, (n, 4, 32)), ("h", h, (n, 32)), ("r", r, (n, 4, 32)),
                           ("left", left, (n, 4, 32))):
        _build.check_tensor(t, name, torch.uint8, shape, dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = _lib().ba_window_verify(n, a.data_ptr(), h.data_ptr(), r.data_ptr(), left.data_ptr(),
                                  ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-verify launch failed: CUDA error {err}")
    if n:
        window_verify.launches += 1
    return ok


window_verify.launches = 0


def reset_launches() -> None:
    window_verify.launches = 0
