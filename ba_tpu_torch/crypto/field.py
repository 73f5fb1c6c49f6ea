"""Batched GF(2^255 - 19) arithmetic over torch integer tensors: the plain
field that the Ed25519 kernels' plain versions run on.

The port's copy of ``ba_tpu/crypto/field.py``, the same limbs and the same
passes: a field element is 22 signed 12-bit limbs in int32, value =
sum(limb[i] * 2**(12*i)), shape [..., 22].  The bounds are the
reference's:

- normalized limbs are in [0, 4096); add/sub leave limbs in (-8192, 8192)
  without carrying;
- the schoolbook product of two such values is a 43-column convolution
  whose column sums stay below 1.9e9 < 2^31;
- reduction folds limbs >= 22 back with 2^264 = 19 * 2^9 (mod p);
  carries use arithmetic shifts, so negative intermediates flow through.

The product is built from broadcast limb products summed into the 43
columns with ``index_add_`` (CUDA has no integer matmul), so every
function runs on the device of its inputs, CPU or CUDA.  Constants are
made on the device asked for (``constant(v, device)``).  Since the passes
are the reference's, every output equals the reference's limb for limb;
the port's contract with the reference is at canonical values all the
same (``canonical``, ``to_bytes``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BITS = 12
LIMBS = 22
MASK = (1 << BITS) - 1
P_INT = 2**255 - 19
# 2^(12*22) = 2^264 = 2^9 * 2^255 = 19 * 2^9 (mod p)
FOLD = 19 << (BITS * LIMBS - 255)
RADIX = 1 << BITS


def _np_limbs(v: int) -> np.ndarray:
    out = np.zeros(LIMBS, np.int32)
    for i in range(LIMBS):
        out[i] = v & MASK
        v >>= BITS
    if v:
        raise ValueError("value does not fit 22 limbs")
    return out


def constant(v: int, device=None) -> torch.Tensor:
    """The field constant ``v mod p`` as a [22] int32 limb vector."""
    return torch.tensor(_np_limbs(v % P_INT), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _limbs_on(v: int, device: torch.device) -> torch.Tensor:
    """The limbs of v on ``device``, uploaded once a device: a per-call
    upload from pageable memory would make the host wait for the card."""
    return torch.tensor(_np_limbs(v), dtype=torch.int32, device=device)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros((*shape, LIMBS), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _columns(device: torch.device) -> torch.Tensor:
    """Column i + j of the flat limb product a[i] * b[j] (index i*22 + j)."""
    i = torch.arange(LIMBS, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _fold_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: every limb's carry moves up one limb; limb
    21's carry wraps to limb 0 times FOLD.  Exact for negative limbs
    (floor shifts: v == (v >> 12) * 4096 + (v & 4095))."""
    c = x >> BITS
    r = x - c * RADIX
    up = torch.cat([c[..., -1:] * FOLD, c[..., :-1]], dim=-1)
    return r + up


def carry(x: torch.Tensor) -> torch.Tensor:
    """Reduce to multiply-safe carried form: five parallel passes settle
    limbs 1..21 into (-16, 4097) and limb 0 into (-9728, 13824) for
    inputs bounded by ~4.4e7 (``ba_tpu/crypto/field.py:78``)."""
    for _ in range(5):
        x = _fold_pass(x)
    return x


def _reduce_wide(c: torch.Tensor) -> torch.Tensor:
    """Reduce a 43-column convolution to carried form: two growing passes
    without the fold, then columns 22..43 fold to 0..21 (times FOLD) and
    column 44 folds to limb 1: 2^528 = (19 * 2^9)^2 = (361 << 6) * 2^12."""
    w = c
    for _ in range(2):
        cr = w >> BITS
        r = w - cr * RADIX
        zero = torch.zeros_like(r[..., :1])
        w = torch.cat([r, zero], dim=-1) + torch.cat([zero, cr], dim=-1)
    lo = w[..., :LIMBS] + w[..., LIMBS:2 * LIMBS] * FOLD
    lo = torch.cat([lo[..., :1], lo[..., 1:2] + w[..., 2 * LIMBS:] * (361 << 6),
                    lo[..., 2:]], dim=-1)
    return carry(lo)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply: [..., 22] x [..., 22] -> [..., 22] carried."""
    a, b = torch.broadcast_tensors(a, b)
    flat = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], LIMBS * LIMBS)
    conv = torch.zeros((*a.shape[:-1], 2 * LIMBS - 1), dtype=torch.int32, device=a.device)
    conv.index_add_(-1, _columns(a.device), flat)
    return _reduce_wide(conv)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy add: limbs may leave [0, 4096) but stay multiply-safe."""
    return a + b


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy subtract: limbs may go negative; carry() and mul() handle it."""
    return a - b


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small positive int; k * 13824 must stay inside
    carry()'s ~4.4e7 input bound, so k <= 3000."""
    if not 0 < k <= 3000:
        raise ValueError(f"mul_small: k={k} exceeds carry()'s input bound")
    return carry(a * k)


def sq_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """n successive squarings."""
    for _ in range(n):
        x = mul(x, x)
    return x


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a fixed exponent: square-and-multiply over e's bits, LSB
    first (``field.pow_const``: the same products, so the same limbs)."""
    result = constant(1, a.device).expand(a.shape).clone()
    base = carry(a)
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            result = mul(result, base)
        base = mul(base, base)
    return result


def _tower_250(z, mul=mul, sq_n=sq_n):
    """The 2^k - 1 addition-chain tower (``ba_tpu/ops/powchain.py:48``):
    returns z^(2^250 - 1).  t_k = z^(2^k - 1); t_2k = t_k^(2^k) * t_k."""
    t1 = z
    t2 = mul(sq_n(t1, 1), t1)
    t4 = mul(sq_n(t2, 2), t2)
    t5 = mul(sq_n(t4, 1), t1)
    t10 = mul(sq_n(t5, 5), t5)
    t20 = mul(sq_n(t10, 10), t10)
    t40 = mul(sq_n(t20, 20), t20)
    t50 = mul(sq_n(t40, 10), t10)
    t100 = mul(sq_n(t50, 50), t50)
    t200 = mul(sq_n(t100, 100), t100)
    return mul(sq_n(t200, 50), t50)


def sqrt_chain(z, mul=mul, sq_n=sq_n):
    """z^(2^252 - 3) = z^((p-5)/8): t_250^4 * z, 251 squarings and 11
    multiplies (``ba_tpu/ops/powchain.py:68``)."""
    return mul(sq_n(_tower_250(z, mul, sq_n), 2), z)


def inv_chain(z, mul=mul, sq_n=sq_n):
    """z^(p - 2) = 1/z: p - 2 = (2^250 - 1) * 2^5 + 11, so t_250^32 * z^11,
    257 squarings and 13 multiplies (``ba_tpu/ops/powchain.py:74``).
    z = 0 gives 0."""
    z2 = sq_n(z, 1)
    z9 = mul(sq_n(z2, 2), z)
    z11 = mul(z9, z2)
    return mul(sq_n(_tower_250(z, mul, sq_n), 5), z11)


def inv(a: torch.Tensor) -> torch.Tensor:
    """1/a through the addition chain.  The reference's ``field.inv`` is
    ``pow_const(a, p - 2)``: the same canonical value, other limbs."""
    return inv_chain(a)


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the canonical representative in [0, p), every limb
    in [0, 4096).  Input: any multiply-safe lazy value, even negative."""
    dev = a.device
    # Carried form encodes a value in (-2^20, 2^264); + 16p clears the
    # negative edge without leaving 22 limbs.
    a = carry(carry(a) + _limbs_on(16 * P_INT, dev))
    # 2^256 = 38 (mod p): squash bits 256+ three times.
    for _ in range(3):
        top = a[..., LIMBS - 1:] >> 4
        a = torch.cat([a[..., :1] + top * 38, a[..., 1:LIMBS - 1],
                       a[..., LIMBS - 1:] - top * 16], dim=-1)
        a = _fold_pass(a)
    # Value now in [0, 2p + small): subtract p while >= p, at most 3 times.
    p_limbs = _limbs_on(P_INT, dev)
    for _ in range(3):
        diff = a - p_limbs
        borrow = torch.zeros_like(diff[..., 0])
        limbs = []
        for i in range(LIMBS):
            v = diff[..., i] + borrow
            limbs.append(v & MASK)
            borrow = v >> BITS
        a = torch.where((borrow >= 0)[..., None], torch.stack(limbs, dim=-1), a)
    c = torch.zeros_like(a[..., 0])
    limbs = []
    for i in range(LIMBS):
        v = a[..., i] + c
        limbs.append(v & MASK)
        c = v >> BITS
    return torch.stack(limbs, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical equality: [...] bool."""
    return (canonical(a) == canonical(b)).all(dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == 0).all(dim=-1)


# -- byte / bit conversions (little-endian, RFC 8032 layout) -----------------


def bytes_to_bits(by: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> int32 bits [..., 8n], LSB first within each byte."""
    shifts = torch.arange(8, dtype=torch.int32, device=by.device)
    bits = (by.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*by.shape[:-1], by.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def from_bytes(by: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] little-endian -> limbs [..., 22] (the top bit
    included; callers mask bit 255 where the encoding steals it)."""
    bits = bytes_to_bits(by)
    pad = torch.zeros((*bits.shape[:-1], BITS * LIMBS - 256), dtype=torch.int32,
                      device=by.device)
    grouped = torch.cat([bits, pad], dim=-1).reshape(*bits.shape[:-1], LIMBS, BITS)
    weights = 1 << torch.arange(BITS, dtype=torch.int32, device=by.device)
    return (grouped * weights).sum(dim=-1).to(torch.int32)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian encoding: limbs [..., 22] -> uint8 [..., 32]."""
    a = canonical(a)
    shifts = torch.arange(BITS, dtype=torch.int32, device=a.device)
    bits = ((a[..., :, None] >> shifts) & 1).reshape(*a.shape[:-1], BITS * LIMBS)
    return bits_to_bytes(bits[..., :256])
