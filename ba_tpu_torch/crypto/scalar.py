"""Batched reduction of 512-bit scalars mod L, the Ed25519 group order.

The port's copy of ``ba_tpu/crypto/scalar.py::reduce_mod_l``: the same
fold plan on little-endian 8-bit limbs, byte-identical output.  The
reference keeps its limbs in int32 with bounds that keep every term
inside it; here they are int64, which changes no value.

    L = 2^252 + delta,  delta < 2^125,  so  2^256 = -16 * delta  (mod L)

Three folds at the 2^256 limb boundary shrink 512 bits to ~258, then one
exact fold at 2^252 and one conditional subtract land in [0, L).  It is
K5's plain tail (``ba_tpu_torch/ops/sha512_kernel.py``) and K6's plain
version (``ops/modl.py``).  ``muladd_bytes`` is the signer's k * a + r,
byte-identical with the reference's too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ba_tpu_torch.crypto.oracle import L

DELTA = L - 2**252  # 125 bits
C16 = 16 * DELTA  # the 2^256 fold constant, 129 bits


def _const_limbs(v: int, n: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = v & 0xFF
        v >>= 8
    if v:
        raise ValueError("constant does not fit")
    return out


_C16 = _const_limbs(C16, 17)
_DELTA = _const_limbs(DELTA, 16)
_L32 = _const_limbs(L, 32)


def _mul_const(a: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    """[..., n] limbs times a fixed limb constant -> [..., n + m - 1]."""
    n, m = a.shape[-1], len(c)
    out = torch.zeros((*a.shape[:-1], n + m - 1), dtype=torch.int64, device=a.device)
    for j, cj in enumerate(c):
        if cj:
            out[..., j:j + n] += a * int(cj)
    return out


def _pad(v: torch.Tensor, extra: int) -> torch.Tensor:
    return torch.cat([v, v.new_zeros((*v.shape[:-1], extra))], dim=-1) if extra else v


def _carry(v: torch.Tensor, passes: int, extra: int) -> torch.Tensor:
    """Parallel signed base-256 carry passes, value-preserving; ``extra``
    fresh top limbs give the transient carries room."""
    v = _pad(v, extra)
    zero1 = v.new_zeros((*v.shape[:-1], 1))
    for _ in range(passes):
        c = v >> 8
        v = v - c * 256 + torch.cat([zero1, c[..., :-1]], dim=-1)
    return v


def _exact_chain(v: torch.Tensor) -> torch.Tensor:
    """One sequential exact carry chain: signed limbs of a non-negative
    value that fits the limb count -> limbs in [0, 256)."""
    c = torch.zeros_like(v[..., 0])
    outs = []
    for i in range(v.shape[-1]):
        x = v[..., i] + c
        outs.append(x & 0xFF)
        c = x >> 8
    return torch.stack(outs, dim=-1)


def _bytes_from_signed_limbs(v: torch.Tensor, total: int, extra: int = 2) -> torch.Tensor:
    """Signed limbs of a non-negative value -> canonical uint8 [..., total]
    (zero-padded): three parallel passes, then one exact chain.  The value
    must fit ``8 * (v.shape[-1] + extra)`` bits, or the top carry is lost
    (``ba_tpu/crypto/scalar.py:170``)."""
    v = _exact_chain(_carry(v.to(torch.int64), passes=3, extra=extra))
    return _pad(v, max(0, total - v.shape[-1]))[..., :total].to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _columns32(device: torch.device) -> torch.Tensor:
    """Column i + j of the flat limb product k[i] * a[j] (index i*32 + j)."""
    i = torch.arange(32, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def muladd_bytes(k_bytes: torch.Tensor, a_bytes: torch.Tensor,
                 r_bytes: torch.Tensor) -> torch.Tensor:
    """Batched ``k * a + r`` settled to canonical bytes, unreduced: k, a, r
    uint8 [..., 32] little-endian -> uint8 [..., 64] (the value is below
    2^512; ``ba_tpu/crypto/scalar.py:208``).  The signer's S before its
    reduction mod L.  The 63 columns of the 32 x 32 schoolbook product are
    summed in int32 with ``index_add_`` (the reference multiplies by a 0/1
    matrix, and a float product on the card may run in TF32); terms peak
    at 32 * 255^2 + 255 ~ 2.08e6."""
    k = k_bytes.to(torch.int32)
    a = a_bytes.to(torch.int32)
    flat = (k[..., :, None] * a[..., None, :]).reshape(*k.shape[:-1], 32 * 32)
    conv = torch.zeros((*k.shape[:-1], 63), dtype=torch.int32, device=k.device)
    conv.index_add_(-1, _columns32(k.device), flat)
    conv = torch.cat([conv[..., :32] + r_bytes.to(torch.int32), conv[..., 32:]], dim=-1)
    return _bytes_from_signed_limbs(conv, 64)


def _fold_256(v: torch.Tensor, keep: int) -> torch.Tensor:
    """One 2^256-boundary fold: v = v[:32] - v[32:] * C16 (mod L)."""
    lo, hi = v[..., :32], v[..., 32:]
    prod = _mul_const(hi, _C16)
    n = max(32, prod.shape[-1], keep)
    return _pad(lo, n - 32) - _pad(prod, n - prod.shape[-1])


def reduce_mod_l(h_bytes: torch.Tensor) -> torch.Tensor:
    """Batched ``h mod L``: uint8 [..., 64] little-endian -> uint8 [..., 32]."""
    v = h_bytes.to(torch.int64)  # 64 limbs in [0, 256); value < 2^512
    v = _fold_256(v, keep=48)  # value in (-2^385, 2^257)
    v = _carry(v, passes=3, extra=3)  # 51 limbs, each in [-1, 256]
    v = _fold_256(v, keep=35)  # value in (-2^259, 2^257 + 2^259)
    v = _carry(v, passes=3, extra=2)  # 37 limbs
    v = _fold_256(v, keep=33)  # value in (-2^135, 2^257)
    v = _carry(v, passes=2, extra=1)  # 34 limbs
    l32 = torch.tensor(_L32, device=v.device)
    # + L (> 2^135) makes the value non-negative, < 2^258.
    v = torch.cat([v[..., :32] + l32, v[..., 32:]], dim=-1)
    v = _exact_chain(_carry(v, passes=2, extra=1))  # value in (0, 2^258)
    # Exact fold at 2^252: hi < 64, so hi * delta < 2^131.
    hi = (v[..., 31] >> 4) + v[..., 32] * 16 + v[..., 33] * (16 * 256)
    lo = torch.cat([v[..., :31], v[..., 31:32] & 0xF], dim=-1)
    prod = _mul_const(hi[..., None], _DELTA)  # 16 limbs
    v = torch.cat([lo[..., :16] - prod, lo[..., 16:]], dim=-1)  # (-2^131, 2^252)
    # + L once -> (0, 2L); then one conditional subtract of L -> [0, L).
    v = _exact_chain(_carry(v + l32, passes=2, extra=1))[..., :32]
    borrow = torch.zeros_like(v[..., 0])
    diffs = []
    for i in range(32):
        x = v[..., i] - int(_L32[i]) + borrow
        diffs.append(x & 0xFF)
        borrow = x >> 8
    v = torch.where((borrow >= 0)[..., None], torch.stack(diffs, dim=-1), v)
    return v.to(torch.uint8)
