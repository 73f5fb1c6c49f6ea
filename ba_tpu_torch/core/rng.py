"""Bit-exact threefry2x32 and packed fault coins (``ba_tpu/core/rng.py``).

The reference draws every fault coin from jax's threefry2x32 key
derivation, so the port reproduces that derivation word for word
instead of using ``torch.Generator``.  Key data is an explicit int64
tensor ``[..., 2]`` holding two uint32 words; torch has no general
uint32 arithmetic, so the cipher runs in int64 with ``& 0xFFFFFFFF``
after every add and shift.

jax derives keys and bits in one of two modes
(``jax_threefry_partitionable``); both are implemented behind one
module-level flag:

- partitionable (the default, as in jax 0.9.0): ``split(key)[i]`` is
  ``threefry(key, (0, i))``; word ``w`` of ``bits(key, (N,))`` is
  ``y0 ^ y1`` of ``threefry(key, (0, w))``;
- the original mode: counter-mode words over ``iota`` with jax's pair
  schedule (the first half of the counts pairs with the second half,
  odd sizes pad one zero count).

``fold_in(key, d)`` is ``threefry(key, (0, d))`` in both modes.
A key from ``key(seed)`` has data ``(0, seed & 0xFFFFFFFF)``: jax cuts
the seed to 32 bits.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ba_tpu_torch.core.state import resolve_device
from ba_tpu_torch.core.types import COMMAND_DTYPE

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

_partitionable = True


def threefry_partitionable() -> bool:
    """The active derivation mode (True matches jax 0.9.0's default)."""
    return _partitionable


@contextlib.contextmanager
def partitionable(flag: bool):
    """Run the block under the given threefry mode, then restore it."""
    global _partitionable
    prev = _partitionable
    _partitionable = bool(flag)
    try:
        yield
    finally:
        _partitionable = prev


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """One threefry2x32 block on int64 tensors holding uint32 values
    (any mutually broadcastable shapes) -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """Key data for ``seed``: int64 ``[2]`` = ``(0, seed & 0xFFFFFFFF)``."""
    return torch.tensor(
        [0, int(seed) & M32], dtype=torch.int64, device=resolve_device(device)
    )


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The raw words of a key: keys ARE their data here (int64 ``[..., 2]``)."""
    return k


def _words(k: torch.Tensor):
    k = k.to(torch.int64)
    return k[..., 0], k[..., 1]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``threefry(key, (0, data))``; ``data`` is cut to 32 bits (an int32
    -1 folds as 0xFFFFFFFF).  Broadcasts keys ``[..., 2]`` against data."""
    k0, k1 = _words(k)
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` subkeys of each key: ``[..., 2]`` -> ``[..., num, 2]``."""
    k0, k1 = _words(k)
    k0, k1 = k0[..., None], k1[..., None]
    if _partitionable:
        i = torch.arange(num, dtype=torch.int64, device=k.device)
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
        return torch.stack([y0, y1], dim=-1)
    counts = torch.arange(2 * num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k0, k1, counts[:num], counts[num:])
    flat = torch.cat([y0, y1], dim=-1)
    return flat.reshape(*flat.shape[:-1], num, 2)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """uint32 words (as int64) of ``jax.random.bits(key, shape, uint32)``;
    keys ``[..., 2]`` give ``[..., *shape]``."""
    shape = tuple(shape)
    size = math.prod(shape)
    k0, k1 = _words(k)
    k0, k1 = k0[..., None], k1[..., None]
    w = torch.arange(size, dtype=torch.int64, device=k.device)
    if _partitionable:
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(w), w)
        out = y0 ^ y1
    else:
        if size % 2:
            w = torch.cat([w, w.new_zeros(1)])
        half = w.shape[0] // 2
        y0, y1 = threefry2x32(k0, k1, w[:half], w[half:])
        out = torch.cat([y0, y1], dim=-1)[..., :size]
    return out.reshape(*out.shape[:-1], *shape)


def coin_words(k: torch.Tensor, size: int) -> torch.Tensor:
    """The packed word stream behind a ``coin_bits`` draw of ``size`` coins."""
    return bits(k, (-(-size // 32),))


def unpack_coin_words(words: torch.Tensor, shape, dtype=COMMAND_DTYPE) -> torch.Tensor:
    """Row-major gather unpack of :func:`coin_words`: coin ``e`` is bit
    ``e // nwords`` of word ``e % nwords`` (``coin_bits``'s mapping).
    ``words`` may carry leading batch axes."""
    shape = tuple(shape)
    size = math.prod(shape)
    nwords = -(-size // 32)
    e = torch.arange(size, dtype=torch.int64, device=words.device)
    picked = words[..., e % nwords] >> (e // nwords)
    return (picked & 1).to(dtype).reshape(*words.shape[:-1], *shape)


def coin_bits(k: torch.Tensor, shape, dtype=COMMAND_DTYPE) -> torch.Tensor:
    """iid fair coins of ``shape`` (0/1 in ``dtype``): the ``[32, nwords]``
    bit-index-major unpack of ``bits`` — coin ``e`` is bit ``e // nwords``
    of word ``e % nwords``."""
    shape = tuple(shape)
    size = math.prod(shape)
    words = coin_words(k, size)
    shifts = torch.arange(32, dtype=torch.int64, device=k.device)
    unpacked = (words[..., None, :] >> shifts[:, None]) & 1
    flat = unpacked.reshape(*words.shape[:-1], -1)[..., :size]
    return flat.to(dtype).reshape(*words.shape[:-1], *shape)


def uniform_u8(k: torch.Tensor, shape) -> torch.Tensor:
    """iid uniform draws on [0, 256) as int32, 4 a word: draw ``e`` is
    byte ``e // nwords`` of word ``e % nwords`` (``coin_bits``'s
    orientation).  Keys ``[..., 2]`` give ``[..., *shape]``."""
    shape = tuple(shape)
    size = math.prod(shape)
    words = bits(k, (-(-size // 4),))
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=k.device)
    vals = (words[..., None, :] >> shifts[:, None]) & 0xFF
    flat = vals.reshape(*words.shape[:-1], -1)[..., :size]
    return flat.to(torch.int32).reshape(*words.shape[:-1], *shape)


def or_coin_threshold8(k_cnt: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """8-bit threshold T with P(uniform_u8 < T) = 1 - 2^-k: exact for
    k <= 8, saturating at 256 beyond; ``gate`` False forces 0."""
    t = torch.where(k_cnt > 8, 256, 256 - (256 >> k_cnt.clamp(max=8)))
    return torch.where(gate, t, torch.zeros_like(t))


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bit-exact.

    jax's two-word form, not rejection sampling: split the key, draw a
    higher and a lower word per value, and fold them modulo the span
    with jax's multiplier ``(2**16 % span)**2 % span``, every product and
    sum wrapping in uint32 as jax's do (so a span above 2**16 can wrap
    the multiplier itself).  A span of
    ``maxval <= minval`` is 1, so ``minval`` comes back.  ``minval`` and
    ``maxval`` broadcast against ``shape``.
    """
    shape = tuple(shape)
    dev = k.device
    lo = torch.as_tensor(minval, device=dev).to(torch.int64).clamp(-2**31, 2**31 - 1)
    hi = torch.as_tensor(maxval, device=dev).to(torch.int64).clamp(-2**31, 2**31 - 1)
    k1, k2 = split(k).unbind(-2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & M32)
    mult = ((2**16 % span) ** 2 & M32) % span
    offset = ((higher % span) * mult & M32) + lower % span
    offset = (offset & M32) % span
    out = (lo + offset) & M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1)), bit-exact:
    ``bits >> 9 | 0x3f800000`` reinterpreted as float32, minus 1."""
    words = (bits(k, tuple(shape)) >> 9) | 0x3F800000
    floats = words.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
