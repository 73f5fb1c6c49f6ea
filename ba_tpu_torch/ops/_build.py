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

The compiler's ``-Xptxas=-v`` report is written beside each library
(``<library>.ptxas.txt``), so a library built by an earlier process still
has it: :func:`library_record` reads each kernel's registers, spill and
shared and local memory from it (:func:`ptxas_resources`), the device
tier's artifact record (``obs/cuda.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    _log_path(out).write_text(build_log[name])  # before the library: its presence means both
    os.replace(tmp, out)
    return out


def _log_path(library: Path) -> Path:
    return library.with_name(library.name + ".ptxas.txt")


def nvcc_release() -> str | None:
    """The CUDA toolkit's release (``nvcc --version``'s ``release X.Y``),
    or None where there is no toolkit."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        return None
    try:
        text = subprocess.run([found, "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"release (\d+\.\d+)", text)
    return m.group(1) if m else None


def ptxas_resources(log: str) -> dict:
    """Each kernel entry's resources from an ``-Xptxas=-v`` report:
    ``{mangled name: {"registers", "spill_stores", "spill_loads",
    "stack_frame", "shared_bytes", "local_bytes"}}`` (bytes; local memory
    a thread is its stack frame, spill included, or the report's ``lmem``
    where larger)."""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": 0, "spill_loads": 0,
                          "stack_frame": 0, "shared_bytes": 0, "local_bytes": 0}
        elif m := re.search(r"Function properties for (\w+)", ln):
            props = m.group(1)  # an entry's, or a device function's kept out of line
        elif entry is not None and props == entry and "spill stores" in ln:
            rec = out[entry]
            rec["stack_frame"] = int(re.search(r"(\d+) bytes stack frame", ln).group(1))
            rec["local_bytes"] = max(rec["local_bytes"], rec["stack_frame"])
            rec["spill_stores"], rec["spill_loads"] = (
                int(x) for x in re.findall(r"(\d+) bytes spill", ln))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", ln)):
            rec = out[entry]
            rec["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", ln):
                rec["shared_bytes"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes lmem", ln):
                rec["local_bytes"] = max(rec["local_bytes"], int(m.group(1)))
    return out


def library_record(source: str, flags: tuple = ()) -> dict:
    """What the build of ``csrc/<source>`` (with ``flags``) left: ``{"path",
    "bytes" (the library's size), "kernels" (:func:`ptxas_resources` of its
    report, {} when the report is missing)}``; builds it if need be."""
    path = build(source, flags)
    log = _log_path(path)
    return {"path": str(path), "bytes": path.stat().st_size,
            "kernels": ptxas_resources(log.read_text()) if log.exists() else {}}


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
