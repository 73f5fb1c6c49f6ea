"""P, the field-multiply probe (``csrc/fieldmul_probe.cu``), and its plain
torch version.

P replaces the Pallas probe kernel of ``bench.py``'s
``make_fieldmul_probe`` (its kernel at ``bench.py:3404``): a measured
floor of the card's GF(2^255 - 19) multiply rate, reported beside K3''s
own rate in BASELINE config #3.  Per lane, CHAINS independent chains
start at a + c (c = 0 .. 7) and each multiplies by b DEPTH times, 512
multiplies a lane; the lane's output is the sum of the chains as a
canonical encoding.  Interface:

    a, b uint8 [S, 32]  ->  uint8 [S, 32]

Bit 255 of a and b is dropped, as the kernel's ``fe_frombytes`` drops it.

:func:`fieldmul_probe` runs the plain version on a CPU tensor and
launches P on a CUDA one, or raises; it keeps a plain integer
``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build

SOURCE = "fieldmul_probe.cu"
CHAINS, DEPTH = 8, 64
MULTIPLIES = CHAINS * DEPTH  # a lane


def _low255(x: torch.Tensor) -> torch.Tensor:
    return F.from_bytes(torch.cat([x[:, :31], x[:, 31:] & 0x7F], dim=1))


def plain_fieldmul_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of P: the same chains on ``crypto/field.py``."""
    fa, fb = _low255(a), _low255(b)
    accs = [F.add(fa, F.constant(c, a.device)) for c in range(CHAINS)]
    for _ in range(DEPTH):
        accs = [F.mul(acc, fb) for acc in accs]
    return F.to_bytes(F.carry(sum(accs)))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_fieldmul_probe
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def fieldmul_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The probe's chains a lane: a, b uint8 [S, 32] -> uint8 [S, 32]."""
    dev = a.device
    if a.dim() != 2 or a.shape[1] != 32:
        raise ValueError(f"a must be [S, 32], got {tuple(a.shape)}")
    if dev.type == "cpu":
        return plain_fieldmul_probe(a, b)
    if dev.type != "cuda":
        raise ValueError(f"the field-multiply probe runs on a CUDA device, not {dev}")
    n = a.shape[0]
    _build.check_tensor(a, "a", torch.uint8, (n, 32), dev)
    _build.check_tensor(b, "b", torch.uint8, (n, 32), dev)
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_fieldmul_probe(n, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"field-multiply probe launch failed: CUDA error {err}")
    if n:
        fieldmul_probe.launches += 1
    return out


fieldmul_probe.launches = 0


def reset_launches() -> None:
    fieldmul_probe.launches = 0
