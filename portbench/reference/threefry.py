"""Threefry2x32 in jax's partitionable mode, frozen for the benchmark.

Key data is an int64 tensor ``[..., 2]`` holding two uint32 words; the
cipher runs in int64 with ``& 0xFFFFFFFF`` after every add and shift.

- ``fold_in(key, d)`` is ``threefry(key, (0, d))``;
- ``split(key)[i]`` is ``threefry(key, (0, i))``;
- word ``w`` of ``bits(key, (N,))`` is ``y0 ^ y1`` of ``threefry(key, (0, w))``;
- coin ``e`` of ``coin_bits(key, shape)`` is bit ``e // nwords`` of word
  ``e % nwords``.

``threefry_py`` is the same cipher on Python integers, for a handful of
keys on the host.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """One threefry2x32 block on int64 tensors (or Python ints) holding
    uint32 values, any broadcastable shapes -> the two output words."""
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


def threefry_py(key: tuple, x1: int) -> tuple:
    """``threefry(key, (0, x1))`` on Python ints: ``fold_in`` of one key."""
    return threefry2x32(key[0], key[1], 0, x1 & M32)


def seed_key(seed: int) -> tuple:
    """The benchmark's base key of ``seed``: all of its bits, high word
    first (a seed past 32 bits keeps its high bits)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed} must be >= 0")
    return ((seed >> 32) & M32, seed & M32)


def _words(k: torch.Tensor):
    k = k.to(torch.int64)
    return k[..., 0], k[..., 1]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``threefry(key, (0, data))``, keys ``[..., 2]`` broadcast against data."""
    k0, k1 = _words(k)
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` subkeys of each key: ``[..., 2]`` -> ``[..., num, 2]``."""
    k0, k1 = _words(k)
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """uint32 words (as int64) of ``jax.random.bits(key, shape)``: keys
    ``[..., 2]`` give ``[..., *shape]``."""
    shape = tuple(shape)
    k0, k1 = _words(k)
    w = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(w), w)
    out = y0 ^ y1
    return out.reshape(*out.shape[:-1], *shape)


def coin_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """iid fair coins (int8 0/1) of ``shape`` a key: coin ``e`` is bit
    ``e // nwords`` of word ``e % nwords`` of ``bits(key, (nwords,))``."""
    shape = tuple(shape)
    size = math.prod(shape)
    nwords = -(-size // 32)
    words = bits(k, (nwords,)).to(torch.int32)  # bit k of the int32 is bit k of the word
    planes = [((words >> b) & 1).to(torch.int8) for b in range(32)]
    flat = torch.stack(planes, dim=-2).reshape(*words.shape[:-1], 32 * nwords)[..., :size]
    return flat.reshape(*words.shape[:-1], *shape)


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` (int32), jax's two-word form: a higher and a
    lower word a value folded modulo the span with the multiplier
    ``(2**16 % span)**2 % span``, every product wrapping in uint32."""
    shape = tuple(shape)
    dev = k.device
    lo = torch.as_tensor(minval, device=dev).to(torch.int64)
    hi = torch.as_tensor(maxval, device=dev).to(torch.int64)
    k1, k2 = split(k).unbind(-2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & M32)
    mult = ((2**16 % span) ** 2 & M32) % span
    offset = ((higher % span) * mult & M32) + lower % span
    offset = (offset & M32) % span
    out = (lo + offset) & M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform`` (float32 on [0, 1)): ``bits >> 9 | 0x3f800000``
    as float32, minus 1."""
    words = (bits(k, tuple(shape)) >> 9) | 0x3F800000
    return torch.clamp(words.to(torch.int32).view(torch.float32) - 1.0, min=0.0)
