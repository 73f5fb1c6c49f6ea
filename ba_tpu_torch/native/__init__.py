"""Native C++ Ed25519: build, load and wrap the batch host signer.

``ed25519.cpp`` is compiled with ``g++ -O3 -shared -fPIC -fopenmp`` at
first use into ``ba_tpu_torch/native/_build/`` (listed in
``.gitignore``), keyed by a hash of the source and of the generated
``constants.h``, and loaded with ctypes.  Every constant the C++ needs
(SHA-512 round constants, curve constants, base point, group order and
its fold constants) is generated into ``constants.h`` here from the
Python oracle (``ba_tpu_torch.crypto.oracle``).  A failed build raises:
the port has no slower signer to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "ed25519.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: dict = {}  # "cmd", "seconds" and the compiler's output of the last build


def _bytes_arr(name: str, data: bytes) -> str:
    vals = ", ".join(str(b) for b in data)
    return f"static const uint8_t {name}[{len(data)}] = {{{vals}}};\n"


def _u64_arr(name: str, vals: list[int]) -> str:
    body = ", ".join(f"{v}ULL" for v in vals)
    return f"static const uint64_t {name}[{len(vals)}] = {{{body}}};\n"


def _sha512_consts() -> tuple[list[int], list[int]]:
    """SHA-512 round and initial constants (FIPS 180-4: the first 64
    fractional bits of the cube and square roots of the first 80
    primes), pinned to the published first and last values."""

    def iroot(n: int, k: int) -> int:
        x = 1 << ((n.bit_length() + k - 1) // k)
        while True:
            y = ((k - 1) * x + n // x ** (k - 1)) // k
            if y >= x:
                return x
            x = y

    def frac_root_bits(p: int, k: int) -> int:
        return iroot(p << (64 * k), k) & ((1 << 64) - 1)

    primes, c = [], 2
    while len(primes) < 80:
        if all(c % q for q in primes if q * q <= c):
            primes.append(c)
        c += 1
    k64 = [frac_root_bits(p, 3) for p in primes]
    h64 = [frac_root_bits(p, 2) for p in primes[:8]]
    assert k64[0] == 0x428A2F98D728AE22 and k64[79] == 0x6C44198C4A475817
    assert h64[0] == 0x6A09E667F3BCC908 and h64[7] == 0x5BE0CD19137E2179
    return k64, h64


def _gen_header() -> str:
    from ba_tpu_torch.crypto import oracle

    K64, H64 = _sha512_consts()
    P, L = oracle.P, oracle.L
    DELTA = L - 2**252  # 2^256 folds as -16 * DELTA mod L
    C16 = 16 * DELTA
    le = lambda v, n: int(v).to_bytes(n, "little")  # noqa: E731
    parts = [
        "// GENERATED by ba_tpu_torch.native from the Python oracle — do not edit.\n",
        "#pragma once\n#include <stdint.h>\n",
        _u64_arr("SHA512_K", K64),
        _u64_arr("SHA512_H0", H64),
        _bytes_arr("P_BYTES", le(P, 32)),
        _bytes_arr("PM2_BYTES", le(P - 2, 32)),
        _bytes_arr("PM5D8_BYTES", le((P - 5) // 8, 32)),
        _bytes_arr("D_BYTES", le(oracle.D, 32)),
        _bytes_arr("D2_BYTES", le(2 * oracle.D % P, 32)),
        _bytes_arr("SQRTM1_BYTES", le(oracle.SQRT_M1, 32)),
        _bytes_arr("BX_BYTES", le(oracle.B_X, 32)),
        _bytes_arr("BY_BYTES", le(oracle.B_Y, 32)),
        _bytes_arr("L_BYTES", le(L, 32)),
        _bytes_arr("C16_BYTES", le(C16, 17)),
        _bytes_arr("DELTA_BYTES", le(DELTA, 16)),
    ]
    return "".join(parts)


def build() -> Path:
    """Compile unless a library for this exact source and header exists;
    returns the library's path.  Raises when g++ fails."""
    header = _gen_header()
    tag = hashlib.sha256(SOURCE.read_bytes() + header.encode()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"ba_ed25519_{tag}.so"
    if so_path.exists():
        return so_path
    # The header g++ reads lives in a per-tag directory, so a concurrent
    # build with other constants can never swap it mid-compile.
    inc_dir = BUILD_DIR / tag
    inc_dir.mkdir(parents=True, exist_ok=True)
    hdr = inc_dir / "constants.h"
    hdr_tmp = inc_dir / f"constants.h.{os.getpid()}.tmp"
    hdr_tmp.write_text(header)
    os.replace(hdr_tmp, hdr)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-I", str(inc_dir), str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"g++ could not run to build the Ed25519 signer: {exc}") from exc
    build_log.update(cmd=" ".join(cmd), seconds=time.perf_counter() - t0,
                     output=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{build_log['output']}")
    os.replace(tmp, so_path)
    return so_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for name, argtypes in (
                ("ba_ed25519_init", []),
                ("ba_ed25519_publickey_batch", [u8p, ctypes.c_size_t, u8p]),
                ("ba_ed25519_sign_batch",
                 [u8p, u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, u8p]),
                ("ba_ed25519_verify_batch",
                 [u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, u8p, u8p]),
            ):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, None
            lib.ba_ed25519_init()  # one-time table setup, inside the lock
            _lib = lib
        return _lib


def _as_u8(a, shape=None) -> tuple[np.ndarray, object]:
    """A contiguous uint8 copy or view of ``a`` and its pointer; raises
    unless ``a`` has ``shape`` (None in ``shape`` matches any size)."""
    a = np.ascontiguousarray(a, np.uint8)
    if shape is not None and (a.ndim != len(shape) or any(
            want is not None and got != want for got, want in zip(a.shape, shape))):
        raise ValueError(f"expected a uint8 array of shape {shape}, got {a.shape}")
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def publickey_batch(sks: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 secret keys -> [B, 32] public keys (OpenMP-parallel)."""
    lib = _load()
    sks, skp = _as_u8(sks, (None, 32))
    out, outp = _as_u8(np.zeros_like(sks))
    lib.ba_ed25519_publickey_batch(skp, sks.shape[0], outp)
    return out


def sign_batch(sks: np.ndarray, pks: np.ndarray, msgs: np.ndarray) -> np.ndarray:
    """[B, 32] sks + [B, 32] pks + [B, M] msgs -> [B, 64] signatures."""
    lib = _load()
    msgs, mp = _as_u8(msgs, (None, None))
    B, M = msgs.shape
    sks, skp = _as_u8(sks, (B, 32))
    pks, pkp = _as_u8(pks, (B, 32))
    out, outp = _as_u8(np.zeros((B, 64), np.uint8))
    lib.ba_ed25519_sign_batch(skp, pkp, mp, M, B, outp)
    return out


def verify_batch(pks: np.ndarray, msgs: np.ndarray, sigs: np.ndarray) -> np.ndarray:
    """[B, 32] pks + [B, M] msgs + [B, 64] sigs -> [B] bool."""
    lib = _load()
    msgs, mp = _as_u8(msgs, (None, None))
    B, M = msgs.shape
    pks, pkp = _as_u8(pks, (B, 32))
    sigs, sigp = _as_u8(sigs, (B, 64))
    out, outp = _as_u8(np.zeros(B, np.uint8))
    lib.ba_ed25519_verify_batch(pkp, mp, M, B, sigp, outp)
    return out.astype(bool)
