"""Batched reduction of 512-bit scalars mod L, the Ed25519 group order.

The port's copy of ``ba_tpu/crypto/scalar.py::reduce_mod_l``: the same
fold plan on little-endian 8-bit limbs, byte-identical output.  The
reference keeps its limbs in int32 with bounds that keep every term
inside it; here they are int64, which changes no value.

    L = 2^252 + delta,  delta < 2^125,  so  2^256 = -16 * delta  (mod L)

Three folds at the 2^256 limb boundary shrink 512 bits to ~258, then one
exact fold at 2^252 and one conditional subtract land in [0, L).  It is
K5's plain tail (``ba_tpu_torch/ops/sha512_kernel.py``) and K6's plain
version (``ops/modl.py``).  ``muladd_bytes`` is the signer's k * a + r;
``mul_mod_l`` and ``sum_mod_l`` are the batch verifier's z * h and sums
of them; each is byte-identical with the reference's.  The products and
sums come unreduced as well (``muladd_bytes``, ``mul_bytes``,
``sum_bytes``: 64 bytes, K6's input), so a caller on the card reduces
them with K6.
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


WORD_LIMBS = 6  # limbs packed into one int64 word by _bytes_from_signed_limbs


def _bytes_from_signed_limbs(v: torch.Tensor, total: int, extra: int = 2) -> torch.Tensor:
    """Signed limbs of a non-negative value -> canonical uint8 [..., total]
    (zero-padded).  The value must fit ``8 * (v.shape[-1] + extra)`` bits,
    or the top carry is lost (``ba_tpu/crypto/scalar.py:170``).  Three
    parallel passes leave small limbs; WORD_LIMBS of them are packed into
    an int64 word (below 2^57 in size), the words carried in one exact
    chain at 48 bits and unpacked: the reference's bytes, with a chain of
    ~9 steps instead of ~50."""
    v = _carry(v.to(torch.int64), passes=3, extra=extra)
    words = -(-v.shape[-1] // WORD_LIMBS)
    v = _pad(v, words * WORD_LIMBS - v.shape[-1])
    shifts = torch.arange(0, 8 * WORD_LIMBS, 8, device=v.device)
    w = (v.reshape(*v.shape[:-1], words, WORD_LIMBS) * (1 << shifts)).sum(dim=-1)
    c = torch.zeros_like(w[..., 0])
    out = []
    for j in range(words):
        x = w[..., j] + c
        out.append(x & ((1 << 8 * WORD_LIMBS) - 1))
        c = x >> 8 * WORD_LIMBS
    v = ((torch.stack(out, dim=-1)[..., None] >> shifts) & 0xFF).reshape(*v.shape[:-1], -1)
    return _pad(v, max(0, total - v.shape[-1]))[..., :total].to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _columns(n: int, m: int, device: torch.device) -> torch.Tensor:
    """Column i + j of the flat limb product a[i] * b[j] (index i*m + j)."""
    i = torch.arange(n, device=device)
    j = torch.arange(m, device=device)
    return (i[:, None] + j[None, :]).reshape(-1)


def _convolve(a_bytes: torch.Tensor, b_bytes: torch.Tensor) -> torch.Tensor:
    """The schoolbook product of two little-endian byte strings as int32
    columns [..., n + m - 1].  The columns are summed with ``index_add_``
    (the reference multiplies by a 0/1 matrix, and a float product on the
    card may run in TF32, which cannot hold them); a column peaks at
    min(n, m) * 255^2."""
    a = a_bytes.to(torch.int32)
    b = b_bytes.to(torch.int32)
    n, m = a.shape[-1], b.shape[-1]
    flat = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], n * m)
    conv = torch.zeros((*a.shape[:-1], n + m - 1), dtype=torch.int32, device=a.device)
    conv.index_add_(-1, _columns(n, m, a.device), flat)
    return conv


def muladd_bytes(k_bytes: torch.Tensor, a_bytes: torch.Tensor,
                 r_bytes: torch.Tensor) -> torch.Tensor:
    """Batched ``k * a + r`` settled to canonical bytes, unreduced: k, a, r
    uint8 [..., 32] little-endian -> uint8 [..., 64] (the value is below
    2^512; ``ba_tpu/crypto/scalar.py:208``).  The signer's S before its
    reduction mod L: 63 int32 columns (``_convolve``), terms at most
    32 * 255^2 + 255 ~ 2.08e6."""
    conv = _convolve(k_bytes, a_bytes)
    conv = torch.cat([conv[..., :32] + r_bytes.to(torch.int32), conv[..., 32:]], dim=-1)
    return _bytes_from_signed_limbs(conv, 64)


def mul_bytes(a_bytes: torch.Tensor, z_bytes: torch.Tensor) -> torch.Tensor:
    """Batched ``a * z`` settled to canonical bytes, unreduced: a uint8
    [..., 32], z uint8 [..., 16] -> uint8 [..., 64] (the value is below
    2^384).  47 int32 columns, terms at most 16 * 255^2 ~ 1.04e6."""
    return _bytes_from_signed_limbs(_convolve(a_bytes, z_bytes), 64)


def mul_mod_l(a_bytes: torch.Tensor, z_bytes: torch.Tensor) -> torch.Tensor:
    """Batched ``(a * z) mod L``: a uint8 [..., 32], z uint8 [..., 16] ->
    uint8 [..., 32] (``ba_tpu/crypto/scalar.py:187``): a reduced hash or S
    times a 128-bit batch-verify coefficient."""
    return reduce_mod_l(mul_bytes(a_bytes, z_bytes))


def sum_bytes(v_bytes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Batched sum over ``axis`` settled to canonical bytes, unreduced:
    uint8 [..., G, 32] -> uint8 [..., 64].  Exact while G * 255 < 2^31
    (the reference's int32 limb sums); the carry headroom is sized from G
    as the reference sizes it (``ba_tpu/crypto/scalar.py:233``): the sum
    is below G * 2^256, and a fixed two spare limbs would drop its top
    carry from G ~ 2^20 on."""
    G = v_bytes.shape[axis]
    if G * 255 >= 2**31:
        raise ValueError(f"G={G} overflows int32 limb sums (G > ~8.4M)")
    extra = max(2, (252 + G.bit_length() + 7) // 8 + 1 - 32)
    return _bytes_from_signed_limbs(v_bytes.sum(dim=axis, dtype=torch.int64), 64, extra=extra)


def sum_mod_l(v_bytes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Batched ``sum mod L`` over ``axis``: uint8 [..., G, 32] -> [..., 32]."""
    return reduce_mod_l(sum_bytes(v_bytes, axis))


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
