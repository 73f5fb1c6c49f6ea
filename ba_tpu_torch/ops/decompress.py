"""K7, Ed25519 point decompression (``csrc/decompress.cu``), and its plain
torch version.

K7 replaces ``ba_tpu/ops/decompress.py::_decompress_kernel`` (the Pallas
TPU kernel: u, v, the (p-5)/8 chain, both roots and v x^2) and takes in
the root choice, the sign flip and the validity mask that the reference
leaves to XLA (``ba_tpu/crypto/ed25519.py:257-287``).  Its interface:

    enc uint8 [N, 32]  ->  (points uint8 [N, 4, 32], ok bool [N])

``points`` holds the canonical 32-byte encodings of X, Y, Z = 1 and
T = X Y (the kernels' shared point layout).  A lane with ok False holds
what the same steps give, canonical too, so the kernel and
:func:`plain_decompress` agree on every lane.

:func:`decompress` runs the plain version on a CPU tensor and launches K7
on a CUDA one, or raises; it keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto.oracle import D, P, SQRT_M1
from ba_tpu_torch.ops import _build

SOURCE = "decompress.cu"


def plain_decompress(enc: torch.Tensor):
    """The plain version of K7, the steps of ``ed25519.decompress``
    (RFC 8032 5.1.3) on the port's plain field, with the (p-5)/8 power
    through the addition chain as the kernel runs it."""
    dev = enc.device
    sign = (enc[:, 31] >> 7).to(torch.int32)
    masked = torch.cat([enc[:, :31], enc[:, 31:] & 0x7F], dim=1)
    ok = E._lt_const(masked, P)
    y = F.from_bytes(masked)
    one = F.constant(1, dev)
    zero = F.zeros(y.shape[:-1], dev)
    yy = F.square(y)
    u = F.sub(yy, one)
    v = F.carry(F.add(F.mul(yy, F.constant(D, dev)), one))
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    t = F.sqrt_chain(F.mul(u, v7))
    x = F.mul(F.mul(u, v3), t)
    x_alt = F.mul(x, F.constant(SQRT_M1, dev))
    vxx = F.mul(v, F.square(x))
    root1 = F.eq(vxx, u)
    root2 = F.eq(vxx, F.sub(zero, u))
    x = torch.where(root2[:, None], x_alt, x)
    ok = ok & (root1 | root2)
    xc = F.canonical(x)
    ok = ok & ~((xc == 0).all(dim=-1) & (sign == 1))
    flip = (xc[:, 0] & 1) != sign
    xc = torch.where(flip[:, None], F.canonical(F.sub(zero, xc)), xc)
    point = (xc, y, one.expand_as(y), F.mul(xc, y))
    return E.encode_point(point), ok


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_decompress
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def decompress(enc: torch.Tensor):
    """Decompress N encodings: uint8 [N, 32] -> (uint8 [N, 4, 32] points,
    bool [N] validity)."""
    dev = enc.device
    if enc.dim() != 2 or enc.shape[1] != 32:
        raise ValueError(f"enc must be [N, 32], got {tuple(enc.shape)}")
    if dev.type == "cpu":
        return plain_decompress(enc)
    if dev.type != "cuda":
        raise ValueError(f"the decompress kernel runs on a CUDA device, not {dev}")
    n = enc.shape[0]
    _build.check_tensor(enc, "enc", torch.uint8, (n, 32), dev)
    pts = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = _lib().ba_decompress(n, enc.data_ptr(), pts.data_ptr(), ok.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decompress launch failed: CUDA error {err}")
    if n:
        decompress.launches += 1
    return pts, ok


decompress.launches = 0


def reset_launches() -> None:
    decompress.launches = 0
