"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``; and check the tensors a
wrapper hands a kernel (``check_tensor``).

The library is keyed by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags (NVCC_FLAGS and any a caller adds, such
as a ``-D`` for an instrumented build), built at first use into
``ba_tpu_torch/ops/_build/`` (listed in ``.gitignore``) and reused while
the source is unchanged.  No PyTorch headers are compiled
in, which keeps a cold build to seconds.  A failed build raises; there
is no fallback to the plain engine.  ``check_aligned`` guards the
kernels that move a lane by 16-byte vectors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict = {}
_local = threading.local()  # first loads of a library, by the thread that made them
loads_total = 0  # first loads of a library in the process, by any thread
build_log: dict = {}  # source name (and added flags) -> the compiler's output of its last build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def _name(source: str, flags: tuple) -> str:
    return " ".join((source, *flags))


def build(source: str, flags: tuple = ()) -> Path:
    """Compile ``csrc/<source>`` with NVCC_FLAGS and ``flags`` unless a
    library for this exact source, headers and flags exists; returns the
    library's path."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS + tuple(flags)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    name = _name(source, flags)
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{build_log[name]}")
    os.replace(tmp, out)
    return out


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel reads through a raw pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(t, name: str, align: int = 16) -> None:
    """Raise unless ``t``'s base address is a multiple of ``align`` bytes:
    what a kernel that reads or writes it by vector loads needs."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary "
                         f"(its base is {t.data_ptr() % align} bytes past one)")


def load(source: str, flags: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>`` (built with ``flags``
    added), built on first use."""
    global loads_total
    with _lock:
        name = _name(source, flags)
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(source, flags)))
            _local.loads = thread_loads() + 1
            loads_total += 1
        return lib


def thread_loads() -> int:
    """Libraries this thread has built or loaded first in the process:
    the serving tier counts a rise during a dispatch as a compile on the
    request path."""
    return getattr(_local, "loads", 0)
