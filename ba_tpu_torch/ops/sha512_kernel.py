"""K5, SHA-512 then mod L (``csrc/sha512_modl.cu``), and its plain torch
version.

K5 replaces ``ba_tpu/ops/sha512_kernel.py::_sha_modl_kernel`` (the Pallas
TPU kernel): the compression over ``n_blocks`` padded blocks, its digest's
16 little-endian words (the state's halves byte-swapped) fed straight into
K6's word-form reduction mod L (``csrc/modl.cuh``).
For verification the input is R || A || M (80 bytes: one block), and the
output the challenge scalar h = SHA-512(R || A || M) mod L.  Interface, as
the reference's:

    wh, wl int64 [S, n_blocks, 16] (uint32 halves)  ->  uint8 [S, 32]

K5' replaces ``_sha_kernel`` of the same file, the raw compression that
the signer's key expansion SHA-512(sk) runs: the same input, and the
digest uint8 [S, 64] (big-endian state words) where the reference writes
the 16 state halves.

:func:`sha512_blocks_mod_l` and :func:`sha512_blocks` run the plain
version on a CPU tensor and launch their kernel on a CUDA one, or raise;
each keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import sha512
from ba_tpu_torch.crypto.scalar import reduce_mod_l
from ba_tpu_torch.ops import _build

SOURCE = "sha512_modl.cu"


def plain_sha512_blocks_mod_l(wh: torch.Tensor, wl: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The plain version of K5: the port's SHA-512 compression on (hi, lo)
    halves, then ``reduce_mod_l`` of the digest."""
    return reduce_mod_l(sha512.digest_bytes(sha512.compress_blocks(wh, wl, n_blocks)))


def plain_sha512_blocks(wh: torch.Tensor, wl: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The plain version of K5': the port's SHA-512 compression on (hi,
    lo) halves, as digest bytes."""
    return sha512.digest_bytes(sha512.compress_blocks(wh, wl, n_blocks))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for fn in (lib.ba_sha512_modl, lib.ba_sha512):
        if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
            fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, wh, wl, n_blocks: int, width: int, plain):
    """Check the halves, then run ``plain`` on a CPU tensor or launch the
    kernel ``ba_<name>`` with an output of ``width`` bytes a lane."""
    dev = wh.device
    if wh.dim() != 3 or tuple(wh.shape[1:]) != (n_blocks, 16) or n_blocks < 1:
        raise ValueError(f"wh must be [S, {n_blocks}, 16], got {tuple(wh.shape)}")
    if dev.type == "cpu":
        return plain(wh, wl, n_blocks), False
    if dev.type != "cuda":
        raise ValueError(f"the SHA-512 kernels run on a CUDA device, not {dev}")
    S = wh.shape[0]
    _build.check_tensor(wh, "wh", torch.int64, (S, n_blocks, 16), dev)
    _build.check_tensor(wl, "wl", torch.int64, (S, n_blocks, 16), dev)
    _build.check_aligned(wh, "wh")
    _build.check_aligned(wl, "wl")
    out = torch.empty((S, width), dtype=torch.uint8, device=dev)
    err = getattr(_lib(), f"ba_{name}")(S, n_blocks, wh.data_ptr(), wl.data_ptr(),
                                        out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out, S > 0


def sha512_blocks_mod_l(wh: torch.Tensor, wl: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """SHA-512 of ``n_blocks`` padded blocks a lane, reduced mod L:
    wh / wl int64 [S, n_blocks, 16] -> uint8 [S, 32] little-endian."""
    out, launched = _launch("sha512_modl", wh, wl, n_blocks, 32, plain_sha512_blocks_mod_l)
    if launched:
        sha512_blocks_mod_l.launches += 1
    return out


def sha512_blocks(wh: torch.Tensor, wl: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """SHA-512 of ``n_blocks`` padded blocks a lane: wh / wl int64
    [S, n_blocks, 16] -> the digest, uint8 [S, 64]."""
    out, launched = _launch("sha512", wh, wl, n_blocks, 64, plain_sha512_blocks)
    if launched:
        sha512_blocks.launches += 1
    return out


sha512_blocks_mod_l.launches = 0
sha512_blocks.launches = 0


def reset_launches() -> None:
    sha512_blocks_mod_l.launches = 0
    sha512_blocks.launches = 0
