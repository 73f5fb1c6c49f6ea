"""Batched SHA-512 over torch integer tensors: the plain versions of K5
and K5'.

The port's copy of ``ba_tpu/crypto/sha512.py``.  Every 64-bit word is an
(hi, lo) pair of 32-bit halves held in int64 tensors, as the reference
holds uint32 pairs: torch's ``>>`` on int64 is an arithmetic shift and its
uint64 support is partial, so the halves stay in [0, 2^32) and are masked
after every left shift and add.  The 80 rounds unroll in Python with the
message schedule as a list, as the reference's kernel body does.  The
CUDA kernels (``ops/csrc/sha512_modl.cu``) use native ``uint64_t``.

The round constants and initial state are computed as the reference
computes them (the first 64 fractional bits of the cube and square roots
of the first primes) and checked against the published first and last
values.  Message length is fixed per call; the padding layout is
computed in Python per length.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _iroot(n: int, k: int) -> int:
    """Floor integer k-th root by Newton iteration on Python ints."""
    if n == 0:
        return 0
    x = 1 << ((n.bit_length() + k - 1) // k)
    while True:
        y = ((k - 1) * x + n // x ** (k - 1)) // k
        if y >= x:
            return x
        x = y


def _frac_root_bits(p: int, k: int) -> int:
    """First 64 bits of the fractional part of p**(1/k)."""
    return _iroot(p << (64 * k), k) & ((1 << 64) - 1)


def _primes(count: int) -> list[int]:
    out, c = [], 2
    while len(out) < count:
        if all(c % q for q in out if q * q <= c):
            out.append(c)
        c += 1
    return out


_P80 = _primes(80)
K64 = [_frac_root_bits(p, 3) for p in _P80]
H64 = [_frac_root_bits(p, 2) for p in _P80[:8]]
if K64[0] != 0x428A2F98D728AE22 or K64[79] != 0x6C44198C4A475817 \
        or H64[0] != 0x6A09E667F3BCC908 or H64[7] != 0x5BE0CD19137E2179:
    raise AssertionError("SHA-512 constants disagree with FIPS 180-4")


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _add64_many(*pairs):
    h, l = pairs[0]
    for ph, pl in pairs[1:]:
        h, l = _add64(h, l, ph, pl)
    return h, l


def _rotr64(h, l, n: int):
    n %= 64
    if n == 0:
        return h, l
    if n == 32:
        return l, h
    if n > 32:
        h, l, n = l, h, n - 32
    return (h >> n) | ((l << (32 - n)) & M32), (l >> n) | ((h << (32 - n)) & M32)


def _shr64(h, l, n: int):
    if n < 32:
        return h >> n, (l >> n) | ((h << (32 - n)) & M32)
    return torch.zeros_like(h), h >> (n - 32)


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _big_sigma0(h, l):
    return _xor3(_rotr64(h, l, 28), _rotr64(h, l, 34), _rotr64(h, l, 39))


def _big_sigma1(h, l):
    return _xor3(_rotr64(h, l, 14), _rotr64(h, l, 18), _rotr64(h, l, 41))


def _small_sigma0(h, l):
    return _xor3(_rotr64(h, l, 1), _rotr64(h, l, 8), _shr64(h, l, 7))


def _small_sigma1(h, l):
    return _xor3(_rotr64(h, l, 19), _rotr64(h, l, 61), _shr64(h, l, 6))


def _compress(state: list, wh: torch.Tensor, wl: torch.Tensor) -> list:
    """One 1024-bit block: ``state`` is 8 (hi, lo) pairs of [B] int64;
    wh / wl are [B, 16] big-endian word halves.  Returns the new state."""
    w = [(wh[:, i], wl[:, i]) for i in range(16)]
    regs = list(state)
    for t in range(80):
        if t >= 16:
            w.append(_add64_many(_small_sigma1(*w[t - 2]), w[t - 7],
                                 _small_sigma0(*w[t - 15]), w[t - 16]))
        a, b, c, d, e, f, g, h = regs
        ch = (e[0] & f[0]) ^ ((e[0] ^ M32) & g[0]), (e[1] & f[1]) ^ ((e[1] ^ M32) & g[1])
        t1 = _add64_many(h, _big_sigma1(*e), ch, (K64[t] >> 32, K64[t] & M32), w[t])
        maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
               (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t2 = _add64(*_big_sigma0(*a), *maj)
        regs = [_add64(*t1, *t2), a, b, c, _add64(*d, *t1), e, f, g]
    return [_add64(*s, *r) for s, r in zip(state, regs)]


def _pad_layout(nbytes: int) -> tuple[int, np.ndarray]:
    """(n_blocks, tail) for a message of ``nbytes``: the tail is the
    padding appended (0x80, zeros, the 128-bit big-endian bit length)."""
    pad_len = (112 - (nbytes + 1)) % 128
    tail = np.zeros(1 + pad_len + 16, np.uint8)
    tail[0] = 0x80
    tail[-16:] = np.frombuffer((nbytes * 8).to_bytes(16, "big"), np.uint8)
    if (nbytes + len(tail)) % 128:
        raise AssertionError("padding layout")
    return (nbytes + len(tail)) // 128, tail


def _message_words(msg: torch.Tensor):
    """Pad and split a batch of equal-length messages into big-endian word
    halves: uint8 [B, L] -> (wh, wl) int64 [B, n_blocks, 16], n_blocks."""
    B, nbytes = msg.shape
    n_blocks, tail = _pad_layout(nbytes)
    # The tail is filled on the message's device: a copy from host memory
    # (torch.tensor, or item assignment) would wait for the work queued
    # before it, where fill_ passes its value with the launch.
    tail_t = torch.zeros(len(tail), dtype=torch.uint8, device=msg.device)
    for i in np.flatnonzero(tail).tolist():
        tail_t[i:i + 1].fill_(int(tail[i]))
    padded = torch.cat([msg.to(torch.uint8), tail_t.expand(B, len(tail))], dim=1)
    by = padded.reshape(B, n_blocks * 32, 4).to(torch.int64)
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]
    words = words.reshape(B, n_blocks, 16, 2)
    return words[..., 0].contiguous(), words[..., 1].contiguous(), n_blocks


def compress_blocks(wh: torch.Tensor, wl: torch.Tensor, n_blocks: int) -> list:
    """The state after ``n_blocks`` blocks from the initial state: 8 (hi,
    lo) pairs of [B] int64."""
    B = wh.shape[0]
    state = [(torch.full((B,), h >> 32, dtype=torch.int64, device=wh.device),
              torch.full((B,), h & M32, dtype=torch.int64, device=wh.device)) for h in H64]
    for blk in range(n_blocks):
        state = _compress(state, wh[:, blk], wl[:, blk])
    return state


def digest_bytes(state: list) -> torch.Tensor:
    """8 (hi, lo) state pairs -> the uint8 [B, 64] digest (big-endian
    words, hi half first)."""
    out = []
    for pair in state:
        for word in pair:
            out.extend((word >> s) & 0xFF for s in (24, 16, 8, 0))
    return torch.stack(out, dim=1).to(torch.uint8)


def sha512(msg: torch.Tensor) -> torch.Tensor:
    """Batched SHA-512: uint8 [B, L] -> uint8 [B, 64], through K5'
    (``ops/sha512_kernel.sha512_blocks``): its kernel on a CUDA tensor,
    its plain version on a CPU one."""
    from ba_tpu_torch.ops.sha512_kernel import sha512_blocks

    wh, wl, n_blocks = _message_words(msg)
    return sha512_blocks(wh, wl, n_blocks)


def sha512_mod_l(msg: torch.Tensor) -> torch.Tensor:
    """Batched ``SHA-512(msg) mod L``: uint8 [B, L] -> uint8 [B, 32],
    through K5 (``ops/sha512_kernel.sha512_blocks_mod_l``): its kernel on
    a CUDA tensor, its plain version on a CPU one."""
    from ba_tpu_torch.ops.sha512_kernel import sha512_blocks_mod_l

    wh, wl, n_blocks = _message_words(msg)
    return sha512_blocks_mod_l(wh, wl, n_blocks)
