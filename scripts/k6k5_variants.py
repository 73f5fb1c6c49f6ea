#!/usr/bin/env python3
"""Time K6 (``ops/csrc/modl.cu``), K5 and K5' (``ops/csrc/sha512_modl.cu``)
on one CUDA card beside variants of their designs, and count their SASS
instructions.

    python3 scripts/k6k5_variants.py [--seed N] [--sass-only]

The variants build from this script's own sources,
``scripts/k6k5_variants/modl_variants.cu`` and ``sha512_variants.cu``
(one nvcc each, in parallel, against the shipped headers; a variant
number a launch), and are listed with what each changes in those files'
headers and in MODL_VARIANTS / K5_VARIANTS / K5P_VARIANTS below.  The
shipped kernels ship one design each: ``shipped`` times the wrapper,
``shipped_raw`` the shipped library's launch alone (ctypes, the output
allocated once); their difference is the wrapper's host cost where the
kernel is shorter than it.  Shapes are the paths': K6 at 1, 1 024,
20 480 and 65 536 lanes (``chip_smoke.modl_inputs``: the edge values,
then muladd_bytes of random scalars and random bytes), K5 at 20 480 and
65 536 lanes of one block (80-byte messages, R || A || M), K5' at 20 480
(32-byte messages, the signer's SHA-512(sk)).  Every output is held
bit-equal to the shipped kernel's, and K5's to the plain version's.

Times are CUDA-event means of 10 launches after a warm one, three rounds
in alternating order, twice: as launched (``ms``: a kernel shorter than
its launch's host cost reads the host's launch rate) and queued behind a
spin (``device_ms``, ``chip_smoke.time_cuda(..., queued=True)``: the card's own
time).  SASS: ``cuobjdump -sass`` of the shipped libraries
and the variants', each kernel's instructions on the integer pipes (all
but moves, branches, the uniform datapath; ``scripts/fe_sass_counts.py``'s
rule).  The probes in the variant sources, straight-line code between a
load and a store, count the least work of each function:
``sha512_block_probe`` one compression block (``chip_smoke.SHA_BLOCK_OPS``),
``modl_probe_fold`` and ``modl_probe_barrett`` the two mod-L plans
(``chip_smoke.MODL_OPS`` is the lesser).  Prints the ptxas records, the
SASS counts, one JSON line a kernel and shape, then the card's
``nvidia-smi`` line; ``--sass-only`` prints only the ptxas records and
the counts.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ba_tpu_torch.crypto import sha512  # noqa: E402
from ba_tpu_torch.ops import _build, modl, sha512_kernel  # noqa: E402
from k9k8_variants import sass_counts  # noqa: E402

VARIANT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k6k5_variants")
VARIANT_SOURCES = ("modl_variants.cu", "sha512_variants.cu")
MODL_VARIANTS = {"v12": 0, "fold": 1, "barrett64": 2, "barrett256": 3, "barrett_lanes2": 4,
                 "barrett_smem": 5, "barrett_bytes": 6}
K5_VARIANTS = {"v12": 0, "fold": 1, "scalar_loads": 2}
K5P_VARIANTS = {"v12": 0}
K6_LANES = (1, 1_024, 20_480, 65_536)
K5_LANES = (20_480, 65_536)
K5P_LANES = (20_480,)
PROBES = ("sha512_block_probe", "modl_probe_fold", "modl_probe_barrett")


def build(source: str, workdir: str):
    """One variant library from this script's copy of a source, and its
    ptxas records."""
    lib = os.path.join(workdir, f"{Path(source).stem}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", lib, os.path.join(VARIANT_DIR, source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return lib, chip_smoke.ptxas_records(proc.stdout + proc.stderr)


def build_all(workdir: str):
    """The shipped libraries and the variants', built in parallel: ({source:
    path}, {source: (path, ptxas records)})."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        shipped = {src: pool.submit(_build.build, src) for src in ("modl.cu", "sha512_modl.cu")}
        variants = {src: pool.submit(build, src, workdir) for src in VARIANT_SOURCES}
        return ({src: str(job.result()) for src, job in shipped.items()},
                {src: job.result() for src, job in variants.items()})


def counts(shipped: dict, variants: dict) -> dict:
    """SASS counts of every kernel of the shipped and variant libraries,
    and the probes' counts (no loops allowed in a probe)."""
    sass = {src: sass_counts(path) for src, path in shipped.items()}
    sass.update({f"{src} (variants)": sass_counts(path) for src, (path, _) in variants.items()})
    probes = {}
    for src, kernels in sass.items():
        for name, c in kernels.items():
            for probe in PROBES:
                if probe in name and probe not in probes:
                    if c["loops"]:
                        raise RuntimeError(f"{probe} has loops: {c['loops']}")
                    probes[probe] = c["int_pipe"]
    return {"sass": sass, "probe_int_ops": probes}


def emit_build(shipped: dict, variants: dict) -> None:
    print(json.dumps({"ptxas_shipped": {src: chip_smoke.ptxas_records(_build.build_log.get(src, ""))
                                        for src in shipped},
                      "ptxas_variants": {src: rec for src, (_, rec) in variants.items()}}),
          flush=True)
    print(json.dumps(counts(shipped, variants)), flush=True)


def raw_launcher(fn, argtypes, args, out):
    """A ctypes launch of ``fn`` on ``args`` (ints and tensors) into ``out``."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        if fn(*vals, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{fn.__name__} launch failed")
        return out
    return run


def rounds(fns: dict, queued: bool) -> dict:
    """Each function's mean ms (``chip_smoke.time_cuda``, as launched or
    queued) in 3 rounds, the order reversed every other."""
    times = {name: [] for name in fns}
    for r in range(3):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(chip_smoke.time_cuda(fns[name], 10, queued=queued))
    return times


def time_all(fns: dict, want: torch.Tensor, what: str) -> dict:
    """Every output held bit-equal to ``want``, then the times as launched
    (``ms``) and queued behind a spin (``device_ms``)."""
    for key, run in fns.items():
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{key} differs from the shipped kernel on {what}")
    return {"ms": rounds(fns, queued=False), "device_ms": rounds(fns, queued=True)}


def run_all(args, shipped: dict, variants: dict) -> None:
    dev = torch.device("cuda")
    rs = np.random.default_rng(args.seed)
    modl_lib = ctypes.CDLL(variants["modl_variants.cu"][0])
    sha_lib = ctypes.CDLL(variants["sha512_variants.cu"][0])
    ptr = ctypes.c_void_p
    for n in K6_LANES:
        h = chip_smoke.modl_inputs(rs, n, dev)
        want = modl.reduce_mod_l_planes(h)
        torch.cuda.synchronize()
        if not torch.equal(want, modl.plain_reduce_mod_l(h)):
            raise RuntimeError(f"K6 differs from its plain version at {n} lanes")
        fns = {"shipped": lambda h=h: modl.reduce_mod_l_planes(h),
               "shipped_raw": raw_launcher(modl._lib().ba_modl, [ctypes.c_int] + [ptr] * 3,
                                           [n, h], torch.empty_like(want))}
        for key, v in MODL_VARIANTS.items():
            fns[key] = raw_launcher(modl_lib.ba_modl_variant, [ctypes.c_int] * 2 + [ptr] * 3,
                                    [v, n, h], torch.empty_like(want))
        nbytes = 96 * n
        print(json.dumps({"kernel": "K6", "lanes": n, "bytes": nbytes,
                          "bytes_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                          **time_all(fns, want, f"{n} lanes")}), flush=True)
    for key5, lanes, nbytes_msg, width, wrapper, entry, variant_entry, table in (
            ("K5", K5_LANES, 80, 32, sha512_kernel.sha512_blocks_mod_l, "ba_sha512_modl",
             "ba_sha512_modl_variant", K5_VARIANTS),
            ("K5'", K5P_LANES, 32, 64, sha512_kernel.sha512_blocks, "ba_sha512",
             "ba_sha512_variant", K5P_VARIANTS)):
        for n in lanes:
            msg = torch.tensor(rs.integers(0, 256, (n, nbytes_msg), dtype=np.uint8), device=dev)
            wh, wl, nb = sha512._message_words(msg)
            want = wrapper(wh, wl, nb)
            plain = (sha512_kernel.plain_sha512_blocks_mod_l if key5 == "K5"
                     else sha512_kernel.plain_sha512_blocks)(wh, wl, nb)
            torch.cuda.synchronize()
            if not torch.equal(want, plain):
                raise RuntimeError(f"{key5} differs from its plain version at {n} lanes")
            fns = {"shipped": lambda wh=wh, wl=wl, nb=nb, f=wrapper: f(wh, wl, nb),
                   "shipped_raw": raw_launcher(getattr(sha512_kernel._lib(), entry),
                                               [ctypes.c_int] * 2 + [ptr] * 4,
                                               [n, nb, wh, wl], torch.empty_like(want))}
            for key, v in table.items():
                fns[key] = raw_launcher(getattr(sha_lib, variant_entry),
                                        [ctypes.c_int] * 3 + [ptr] * 4,
                                        [v, n, nb, wh, wl], torch.empty_like(want))
            nbytes = n * (2 * 8 * 16 * nb + width)
            print(json.dumps({"kernel": key5, "lanes": n, "blocks": nb, "bytes": nbytes,
                              "bytes_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                              **time_all(fns, want, f"{n} lanes")}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sass-only", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6k5_variants: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as workdir:
        shipped, variants = build_all(workdir)
        emit_build(shipped, variants)
        if not args.sass_only:
            run_all(args, shipped, variants)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
