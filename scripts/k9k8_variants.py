#!/usr/bin/env python3
"""Time K9 (``ops/csrc/majority.cu``) and K8 (``compress_kernel`` in
``ops/csrc/powchain.cu``) on one CUDA card beside variants of their
designs, and count their SASS instructions.

    python3 scripts/k9k8_variants.py [--seed N] [--sass-only]

The variants build from this script's own copies of the sources,
``scripts/k9k8_variants/majority_variants.cu`` (under -D flags, one nvcc
each, in parallel) and ``compress_variants.cu`` (one build, a variant
number a launch), against the shipped ``ed25519_field.cuh`` and
``safegcd.cuh``; the shipped kernels ship one design each and are timed
through their wrappers beside them.

K9's variants at the paths' shapes, shared-mask form (config #2's two
resolve levels, [131072, 10, 10, 10] and [131072, 10, 1, 10];
eig_n1024's, [128, 1024, 1, 1024]; the m = 2 sweep's, [64, 16, 1, 16]):
``v1`` (the first port's design: a thread a row of K < 33 with byte loads, or a
warp a row of four-byte words), the copy of the shipped design
(``tile``: 128 threads of 4 rows, cp.async; a warp a longer row, one
16-byte chunk a pass), with plain 16-byte loads instead of cp.async
(``plain_loads``), 2 or 8 rows a thread (``rows2``, ``rows8``), 256
threads (``threads256``), a zero-byte test for each code as first
written (``old_flags``), a resident grid that stages its next tile
while it tallies this one (``double_buffer``, with 8 rows a thread or
256 threads); for K > 32 two chunks a pass, both loads issued first
(``warp_pair``), and 4 or 8 rows a warp with the mask chunks kept while
the mask row repeats (``warp_rows4``, ``warp_rows8``).  K8's: the 2^k -
1 chain at 64- and 32-thread blocks (``chain64``, ``chain32``: the
previous design), Bernstein-Yang divsteps at 32 and 64
(``safegcd32``, ``safegcd64``), and the chain with two threads a lane
(``pair64``, ``pair32``), at 2 and 20 480 lanes of random coordinates
(the paths' lane counts) and 65 536.  Every output is held bit-equal to
the shipped kernel's.  ``shipped`` times the wrapper, ``shipped_raw``
the shipped library's launch alone (ctypes, the output allocated once):
their difference is the wrapper's host cost where the kernel is shorter
than it.

Times are CUDA-event means of 10 launches after a warm one, three rounds
in alternating order.  SASS: ``cuobjdump -sass`` of the shipped libraries
and of the first port's, each kernel's instructions on the integer pipes (all but
moves, branches, the uniform datapath; ``scripts/fe_sass_counts.py``'s
rule) and its loops' bodies; K8's executed count a lane is the kernel's
instructions plus BY_BATCHES - 1 more passes of its one loop (the
divsteps batch).  ``compress_variants.cu``'s ``batch_lane_probe`` (no
loop) counts the least work a lane of K8's function: Montgomery's batch
inversion's three multiplies, the two coordinates' and the canonical
encoding (``chip_smoke.K8_BATCH_LANE_OPS``).  Prints the ptxas records,
the SASS counts, one JSON line a shape and kernel, then the card's
``nvidia-smi`` line; ``--sass-only`` builds K8's sources alone and prints
only their ptxas records and counts.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ba_tpu_torch.ops import _build, majority, powchain  # noqa: E402

VARIANT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k9k8_variants")
K9_VARIANTS = {"tile": (), "plain_loads": ("-DMAJ_CP_ASYNC=0",),
               "rows2": ("-DMAJ_ROWS_A_THREAD=2",), "rows8": ("-DMAJ_ROWS_A_THREAD=8",),
               "threads256": ("-DMAJ_TILE_THREADS=256",), "warp_pair": ("-DMAJ_WARP_PAIR=1",),
               "warp_rows4": ("-DMAJ_WARP_ROWS=4",), "warp_rows8": ("-DMAJ_WARP_ROWS=8",),
               "old_flags": ("-DMAJ_OLD_FLAGS=1",), "double_buffer": ("-DMAJ_DOUBLE_BUFFER=1",),
               "double_buffer_rows8": ("-DMAJ_DOUBLE_BUFFER=1", "-DMAJ_ROWS_A_THREAD=8"),
               "double_buffer_256": ("-DMAJ_DOUBLE_BUFFER=1", "-DMAJ_TILE_THREADS=256")}
K9_SHAPES = {"config2_level1": (131_072, 10, 10, 10), "config2_level0": (131_072, 10, 1, 10),
             "eig_n1024": (128, 1024, 1, 1024), "sweep_m2": (64, 16, 1, 16)}
K8_VARIANTS = {"chain64": 0, "chain32": 1, "safegcd32": 2, "safegcd64": 3, "pair64": 4,
               "pair32": 5}
K8_LANES = (2, 20_480, 65_536)
BY_BATCHES = 20  # safegcd.cuh's batches of 30 divsteps

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"(0x[0-9a-f]+)|`\((\.L_x_\d+)\)")
NOT_INT_PIPE = ("MOV", "BRA", "EXIT", "NOP")


def build(source: str, key: str, flags: tuple, workdir: str):
    """One variant library from this script's copy of a source, and its
    ptxas records."""
    lib = os.path.join(workdir, f"{Path(source).stem}_{key}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
                           "-o", lib, os.path.join(VARIANT_DIR, source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {key}:\n{proc.stderr}")
    return lib, chip_smoke.ptxas_records(proc.stdout + proc.stderr)


def sass_counts(lib_path: str) -> dict:
    """{kernel (mangled): {"int_pipe": static instructions on the integer
    pipes, "all": every instruction, "loops": [int-pipe instructions of
    each backward branch's body]}} from ``cuobjdump -sass``."""
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        instrs, labels, pending = [], {}, []
        for line in part.splitlines():
            m = LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = INSTR.search(line)
            if m:
                addr = int(m.group(1), 16)
                for label in pending:
                    labels[label] = addr
                pending = []
                instrs.append((addr, m.group(3), m.group(4)))

        def int_pipe(ops):
            return sum(1 for o in ops if not (o.split(".")[0] in NOT_INT_PIPE or o.startswith("U")))
        loops = []
        for addr, op, rest in instrs:
            t = TARGET.search(rest) if op.startswith("BRA") else None
            if t:
                target = int(t.group(1), 16) if t.group(1) else labels.get(t.group(2))
                if target is not None and target < addr:
                    loops.append(int_pipe([o for a, o, _ in instrs if target <= a <= addr]))
        out[name] = {"int_pipe": int_pipe([o for _, o, _ in instrs]), "all": len(instrs),
                     "loops": loops,
                     "by_opcode": dict(collections.Counter(o.split(".")[0] for _, o, _ in instrs))}
    return out


def mean_ms(fn, reps=10) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rounds(fns: dict) -> dict:
    """Each function's mean ms in 3 rounds, the order reversed every other."""
    times = {name: [] for name in fns}
    for r in range(3):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(mean_ms(fns[name]))
    return times


def k9_runner(lib, entry, a, v, f, S, P, stream):
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5)
    out = torch.empty(f.shape, dtype=torch.int8, device=f.device)

    def run():
        if fn(f.numel(), a.shape[-1], S, P, a.data_ptr(), v.data_ptr(), f.data_ptr(),
              out.data_ptr(), stream):
            raise RuntimeError(f"K9 {entry} launch failed")
        return out
    return run


def k8_runner(lib, variant, pts, stream):
    fn = lib.ba_compress_variant
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    enc = torch.empty((pts.shape[0], 32), dtype=torch.uint8, device=pts.device)

    def run():
        if fn(variant, pts.shape[0], pts.data_ptr(), enc.data_ptr(), stream):
            raise RuntimeError(f"K8 variant {variant} launch failed")
        return enc
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sass-only", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9k8_variants: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as workdir:
        return k8_sass(workdir) if args.sass_only else run_all(args, workdir)


def k8_counts(powchain_lib: str, variants_lib: str) -> dict:
    """K8's executed integer-pipe instructions a lane: the shipped compress
    by divsteps, and the batch probe's least work."""
    compress = [v for k, v in sass_counts(powchain_lib).items() if "compress_kernel" in k][0]
    probe = [v for k, v in sass_counts(variants_lib).items() if "batch_lane_probe" in k][0]
    if probe["loops"]:
        raise RuntimeError(f"batch_lane_probe has loops: {probe['loops']}")
    return {"k8_compress_int_ops_a_lane":
            compress["int_pipe"] + (BY_BATCHES - 1) * max(compress["loops"]),
            "k8_batch_lane_int_ops": probe["int_pipe"], "batch_lane_probe": probe}


def k8_sass(workdir: str) -> int:
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        shipped = pool.submit(_build.build, "powchain.cu")
        variants = pool.submit(build, "compress_variants.cu", "all", (), workdir)
        shipped, (lib, records) = str(shipped.result()), variants.result()
    print(json.dumps({"ptxas": {"compress": records}, **k8_counts(shipped, lib)}), flush=True)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


def run_all(args, workdir: str) -> int:
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(len(K9_VARIANTS) + 3) as pool:
        shipped = {src: pool.submit(_build.build, src) for src in ("majority.cu", "powchain.cu")}
        jobs = {key: pool.submit(build, "majority_variants.cu", key, flags, workdir)
                for key, flags in K9_VARIANTS.items()}
        jobs["compress"] = pool.submit(build, "compress_variants.cu", "all", (), workdir)
        shipped = {src: str(job.result()) for src, job in shipped.items()}
        built = {key: job.result() for key, job in jobs.items()}
    print(json.dumps({"ptxas": {key: records for key, (_, records) in built.items()},
                      "ptxas_shipped": {src: chip_smoke.ptxas_records(_build.build_log.get(src, ""))
                                        for src in shipped}}), flush=True)
    sass = {"majority.cu": sass_counts(shipped["majority.cu"]),
            "powchain.cu": sass_counts(shipped["powchain.cu"]),
            "v1 (majority_variants.cu)": {k: v for k, v in sass_counts(built["tile"][0]).items()
                                           if "v1_" in k}}
    print(json.dumps({"sass": sass, **k8_counts(shipped["powchain.cu"], built["compress"][0])}),
          flush=True)
    libs = {key: ctypes.CDLL(path) for key, (path, _) in built.items()}

    rs = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, (G, S, P, K) in K9_SHAPES.items():
        a = torch.tensor(rs.integers(-1, 4, (G, S, P, K), dtype=np.int8), device=dev)
        v = torch.tensor(rs.random((G, 1, P, K)) < 0.9, device=dev)
        f = torch.tensor(rs.integers(0, 3, (G, S, P), dtype=np.int8), device=dev)
        want = majority.masked_majority_rows(a, v, f)
        fns = {"v1": k9_runner(libs["tile"], "v1_ba_majority", a, v, f, S, P, stream)}
        for key in K9_VARIANTS:
            fns[key] = k9_runner(libs[key], "ba_majority", a, v, f, S, P, stream)
        for key, run in fns.items():
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K9 {key} differs on {label}")
        fns["shipped"] = lambda a=a, v=v, f=f: majority.masked_majority_rows(a, v, f)
        fns["shipped_raw"] = k9_runner(majority._lib(), "ba_majority", a, v, f, S, P, stream)
        nbytes = a.numel() + v.numel() + 2 * f.numel()
        print(json.dumps({"kernel": "K9", "shape": label, "G_S_P_K": [G, S, P, K],
                          "bytes": nbytes, "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                          "ms": rounds(fns)}), flush=True)
        del a, v, f, want

    pts_all = torch.tensor(rs.integers(0, 256, (max(K8_LANES), 4, 32), dtype=np.uint8),
                           device=dev)
    pts_all[:, :, 31] &= 0x7F
    for n in K8_LANES:
        pts = pts_all[:n].contiguous()
        want = powchain.compress(pts)
        fns = {key: k8_runner(libs["compress"], var, pts, stream)
               for key, var in K8_VARIANTS.items()}
        for key, run in fns.items():
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K8 {key} differs at {n} lanes")
        fns["shipped"] = lambda pts=pts: powchain.compress(pts)
        print(json.dumps({"kernel": "K8", "lanes": n, "ms": rounds(fns)}), flush=True)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
