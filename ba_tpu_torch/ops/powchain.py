"""K8, point compression, and the field exponentiations of
:func:`pow_planes`: K8' (the (p - 5)/8 chain), the p - 2 chain alone and
K8'' (a generic exponent), all in ``csrc/powchain.cu``, with their plain
torch versions.

K8 replaces ``ba_tpu/ops/powchain.py::_inv_chain_kernel`` (the Pallas TPU
kernel, reached through ``pow_planes(z, P - 2)`` from
``ba_tpu/crypto/ed25519.py::compress``) and takes in the rest of
``compress`` that the reference leaves to XLA: x = X / Z, y = Y / Z and
the encoding, the canonical y with the low bit of x in bit 255.  On the
card 1/Z comes from Bernstein and Yang's constant-time divsteps
(``csrc/safegcd.cuh``) rather than the chain: the inverse is unique, so
the bits are the plain version's.  Its interface:

    points uint8 [N, 4, 32]  ->  encodings uint8 [N, 32]

:func:`pow_planes` is the port of ``ba_tpu/ops/powchain.py:130
pow_planes``, the drop-in for ``field.pow_const``: a^e for limbs [N, 22]
in any carried form and a Python int e >= 0.  It routes as the reference
does (``:141-156``), each route one kernel on canonical field elements,
uint8 [N, 32] -> uint8 [N, 32]:

- e = (p - 5)/8: K8' :func:`sqrt_chain`, replacing ``_sqrt_chain_kernel``
  (``:94``), the addition chain of ``field.sqrt_chain``;
- e = p - 2: :func:`inv_chain`, replacing ``_inv_chain_kernel`` (``:101``)
  on its own, the chain of ``field.inv_chain``;
- any other e: K8'' :func:`pow_exp`, replacing ``_pow_kernel`` (``:108``),
  square-and-multiply over e's bits as ``field.pow_const``; on the card
  e has at most ``POW_MAX_BITS`` bits.

It canonicalises a before the kernel and returns canonical limbs, whose
``field.canonical`` equals the reference's.  e = 0 gives 1 and a = 0
gives 0 for e > 0, as ``pow_const``.

Each wrapper (:func:`compress`, :func:`sqrt_chain`, :func:`inv_chain`,
:func:`pow_exp`) runs its plain version on a CPU tensor and launches its
kernel on a CUDA one, or raises; each keeps a plain integer ``launches``
count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build

SOURCE = "powchain.cu"
SQRT_EXP = (F.P_INT - 5) // 8  # 2^252 - 3
INV_EXP = F.P_INT - 2
POW_MAX_BITS = 1024  # the kernel's POW_MAX_WORDS words of exponent


def plain_compress(pts: torch.Tensor) -> torch.Tensor:
    """The plain version of K8: ``ed25519.compress_point`` on the limbs of
    the points, 1/Z through ``field.inv`` (the addition chain).  The
    kernel reads each coordinate's low 255 bits, this version all 256:
    they agree on canonical coordinates, the kernel's inputs."""
    return E.compress_point(E.decode_point(pts))


def _limbs(enc: torch.Tensor) -> torch.Tensor:
    """The low 255 bits of encodings [N, 32] as limbs, as the kernels read
    them."""
    return F.from_bytes(torch.cat([enc[:, :31], enc[:, 31:] & 0x7F], dim=1))


def plain_sqrt_chain(enc: torch.Tensor) -> torch.Tensor:
    """The plain version of K8': ``field.sqrt_chain``."""
    return F.to_bytes(F.sqrt_chain(_limbs(enc)))


def plain_inv_chain(enc: torch.Tensor) -> torch.Tensor:
    """The plain version of the p - 2 route: ``field.inv_chain``."""
    return F.to_bytes(F.inv_chain(_limbs(enc)))


def plain_pow_exp(enc: torch.Tensor, e: int) -> torch.Tensor:
    """The plain version of K8'': ``field.pow_const``."""
    return F.to_bytes(F.pow_const(_limbs(enc), e))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.ba_compress.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        lib.ba_compress.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        for fn in (lib.ba_sqrt_chain, lib.ba_inv_chain):
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.ba_pow.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        for fn in (lib.ba_compress, lib.ba_sqrt_chain, lib.ba_inv_chain, lib.ba_pow):
            fn.restype = ctypes.c_int
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def compress(pts: torch.Tensor) -> torch.Tensor:
    """Encode N points: uint8 [N, 4, 32] -> uint8 [N, 32]."""
    dev = pts.device
    if pts.dim() != 3 or tuple(pts.shape[1:]) != (4, 32):
        raise ValueError(f"pts must be [N, 4, 32], got {tuple(pts.shape)}")
    if dev.type == "cpu":
        return plain_compress(pts)
    if dev.type != "cuda":
        raise ValueError(f"the compress kernel runs on a CUDA device, not {dev}")
    n = pts.shape[0]
    _build.check_tensor(pts, "pts", torch.uint8, (n, 4, 32), dev)
    enc = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_compress(n, pts.data_ptr(), enc.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"compress launch failed: CUDA error {err}")
    if n:
        compress.launches += 1
    return enc


def _on_card(enc: torch.Tensor, what: str) -> bool:
    """Check a field-element tensor; True where a kernel runs it."""
    dev = enc.device
    if enc.dim() != 2 or enc.shape[1] != 32:
        raise ValueError(f"{what}: a must be [N, 32], got {tuple(enc.shape)}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel runs on a CUDA device, not {dev}")
    _build.check_tensor(enc, "a", torch.uint8, (enc.shape[0], 32), dev)
    return True


def _chain(fn_name: str, what: str, enc: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(enc)
    err = getattr(_lib(), fn_name)(enc.shape[0], enc.data_ptr(), out.data_ptr(),
                                   _stream(enc.device))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return out


def sqrt_chain(enc: torch.Tensor) -> torch.Tensor:
    """K8': a^((p - 5)/8) per lane, uint8 [N, 32] -> uint8 [N, 32]."""
    if not _on_card(enc, "sqrt-chain"):
        return plain_sqrt_chain(enc)
    out = _chain("ba_sqrt_chain", "sqrt-chain", enc)
    if enc.shape[0]:
        sqrt_chain.launches += 1
    return out


def inv_chain(enc: torch.Tensor) -> torch.Tensor:
    """The p - 2 route: 1/a per lane (0 for a = 0), uint8 [N, 32] -> uint8
    [N, 32]."""
    if not _on_card(enc, "inv-chain"):
        return plain_inv_chain(enc)
    out = _chain("ba_inv_chain", "inv-chain", enc)
    if enc.shape[0]:
        inv_chain.launches += 1
    return out


def pow_exp(enc: torch.Tensor, e: int) -> torch.Tensor:
    """K8'': a^e per lane for an int e >= 0 (at most POW_MAX_BITS bits on
    the card), uint8 [N, 32] -> uint8 [N, 32]."""
    e = int(e)
    if e < 0:
        raise ValueError(f"the exponent must be >= 0, got {e}")
    if not _on_card(enc, "pow"):
        return plain_pow_exp(enc, e)
    nbits = e.bit_length()
    if nbits > POW_MAX_BITS:
        raise ValueError(f"the pow kernel takes exponents of up to {POW_MAX_BITS} bits, "
                         f"got {nbits}")
    nw = max(-(-nbits // 32), 1)
    words = (ctypes.c_uint32 * nw)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)))
    out = torch.empty_like(enc)
    err = _lib().ba_pow(enc.shape[0], nbits, words, enc.data_ptr(), out.data_ptr(),
                        _stream(enc.device))
    if err != 0:
        raise RuntimeError(f"pow launch failed: CUDA error {err}")
    if enc.shape[0]:
        pow_exp.launches += 1
    return out


def pow_planes(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e: limbs [N, 22] (any carried form) -> canonical limbs [N, 22],
    routed as ``ba_tpu/ops/powchain.py:141-156``."""
    if a.dim() != 2 or a.shape[1] != F.LIMBS:
        raise ValueError(f"a must be [N, {F.LIMBS}], got {tuple(a.shape)}")
    enc = F.to_bytes(a)
    if e == SQRT_EXP:
        out = sqrt_chain(enc)
    elif e == INV_EXP:
        out = inv_chain(enc)
    else:
        out = pow_exp(enc, e)
    return F.from_bytes(out)


compress.launches = 0
sqrt_chain.launches = 0
inv_chain.launches = 0
pow_exp.launches = 0


def reset_launches() -> None:
    compress.launches = 0
    sqrt_chain.launches = 0
    inv_chain.launches = 0
    pow_exp.launches = 0
