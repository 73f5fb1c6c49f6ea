#!/usr/bin/env python3
"""Time K4 (``ops/csrc/treeadd.cu``) and K7 (``ops/csrc/decompress.cu``) on
one CUDA card beside variants of their designs.

    python3 scripts/k4k7_variants.py [--seed N]

The variants build from this script's own copies of the kernels' sources,
``scripts/k4k7_variants/treeadd_variants.cu`` and
``decompress_variants.cu``, under -D flags (one nvcc each, in parallel,
against the shipped ``ed25519_field.cuh``); the shipped kernels ship one
design each and are timed through their wrappers beside them.

K4's variants, each at 1, 2, 4 and 8 threads a lane: ``global`` (the
table read from device memory through the read-only path), ``shared``
(FB_SHARED: the table copied into shared memory once a block, a grid of
resident blocks looping over lanes) and ``zero_entry`` (FB_ZERO_ENTRY: a
9th entry a row, the identity, read for digit 0 instead of the select);
and ``ref10`` (FB_REF10) at one thread a lane: ref10's layout, the even
rows only, the odd windows' sum times 16 by 4 doublings.
Each runs on random 32-byte scalars at 1, 10 240, 20 480 and 65 536
lanes, and on config #3's own S at 65 536 (the S halves of
``signed.sign_received``'s broadcasts on ``default_rng(2)``'s values,
tiled as chip_smoke's config #3 phase tiles them).  Every output is held
bit-equal to the shipped ``treeadd.fixed_base_fold``'s (the fold order
does not depend on the variant), ref10's to its compressed encodings
(another fold: other coordinates of the same point).

K7's variants at 20 480, 30 720, 40 960, 66 560 and 131 072 lanes of
random encodings: the carry order of every product (``serial``, and
ref10's ``two_chains``), two lanes a thread (K7_LANES), 32- and
128-thread blocks (K7_BLOCK), and launch bounds asking for 6, 8, 10 or
16 blocks of 64 a SM at every lane count (K7_CAP_FROM 0, K7_CAP_BLOCKS),
each held bit-equal to the shipped ``decompress``.  K4's ``_min3`` and
``_min4`` ask for 3 or 4 blocks of 128 a SM (FB_MIN_BLOCKS) in every
thread count's instance.

Times are CUDA-event means of 10 launches after a warm one, three
rounds in alternating order.  Prints the builds' ptxas records, one JSON
line a lane count and kernel, then the card's ``nvidia-smi`` line.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ba_tpu_torch.crypto import ed25519, signed  # noqa: E402
from ba_tpu_torch.ops import _build, decompress, treeadd  # noqa: E402

K4_VARIANTS = {"global": ("-DFB_SHARED=0",), "global_min3": ("-DFB_MIN_BLOCKS=3",),
               "global_min4": ("-DFB_MIN_BLOCKS=4",), "shared": ("-DFB_SHARED=1",),
               "zero_entry": ("-DFB_ZERO_ENTRY=1",), "ref10": ("-DFB_REF10=1",),
               "ref10_min4": ("-DFB_REF10=1", "-DFB_MIN_BLOCKS=4")}
NO_CAP = "-DK7_CAP_FROM=2147483647"
K7_VARIANTS = {"serial": ("-DK7_CARRY=0", NO_CAP), "two_chains": ("-DK7_CARRY=1", NO_CAP),
               "serial_lanes2": ("-DK7_CARRY=0", "-DK7_LANES=2", NO_CAP),
               "two_chains_lanes2": ("-DK7_CARRY=1", "-DK7_LANES=2", NO_CAP),
               "two_chains_block32": ("-DK7_CARRY=1", "-DK7_BLOCK=32", NO_CAP),
               "two_chains_block128": ("-DK7_CARRY=1", "-DK7_BLOCK=128", NO_CAP),
               **{f"{carry}_min{b}": (f"-DK7_CARRY={c}", "-DK7_CAP_FROM=0",
                                      f"-DK7_CAP_BLOCKS={b}")
                  for carry, c in (("serial", 0), ("two_chains", 1)) for b in (6, 8, 10, 16)}}
K4_LANES = (1, 10_240, 20_480, 65_536)
VARIANT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k4k7_variants")
SOURCES = {"K4": "treeadd_variants.cu", "K7": "decompress_variants.cu"}
K7_LANES = (20_480, 30_720, 40_960, 66_560, 131_072)


def build(kernel: str, key: str, flags: tuple, workdir: str):
    """One variant's library from this script's copy of the kernel's
    source, and its ptxas records."""
    lib = os.path.join(workdir, f"{kernel}_{key}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
                           "-o", lib, os.path.join(VARIANT_DIR, SOURCES[kernel])],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kernel} {key}:\n{proc.stderr}")
    return ctypes.CDLL(lib), chip_smoke.ptxas_records(proc.stdout + proc.stderr)


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


def zero_entry_table(table: torch.Tensor) -> torch.Tensor:
    """The table with a 9th entry a row, the identity (Y - X = Y + X = 1,
    2d T = 0): int32 [65, 9, 32]."""
    ident = torch.zeros_like(table[:, :1])
    ident[..., 0] = ident[..., 10] = 1
    return torch.cat([table, ident], dim=1).contiguous()


def k4_runner(lib, s, table, threads, stream):
    fn = lib.ba_fixed_base
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    out = torch.empty((s.shape[0], 4, 32), dtype=torch.uint8, device=s.device)

    def run():
        if fn(s.shape[0], threads, s.data_ptr(), table.data_ptr(), out.data_ptr(), stream):
            raise RuntimeError("K4 variant launch failed")
        return out
    return run


def k7_runner(lib, enc, stream):
    fn = lib.ba_decompress
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    pts = torch.empty((enc.shape[0], 4, 32), dtype=torch.uint8, device=enc.device)
    ok = torch.empty((enc.shape[0],), dtype=torch.bool, device=enc.device)

    def run():
        if fn(enc.shape[0], enc.data_ptr(), pts.data_ptr(), ok.data_ptr(), stream):
            raise RuntimeError("K7 variant launch failed")
        return pts, ok
    return run


def config3_s(dev, lanes):
    """Config #3's S column: its 4096 signed broadcasts' S, tiled."""
    sks, pks = signed.commander_keys(64)
    _, sigs = signed.sign_received(sks, pks, np.random.default_rng(2).integers(0, 2, (64, 64)))
    s = np.ascontiguousarray(sigs.reshape(4096, 64)[:, 32:])
    return torch.tensor(s, device=dev).repeat(-(-lanes // 4096), 1)[:lanes].contiguous()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4k7_variants: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as workdir:
        return run_all(args, workdir)


def run_all(args, workdir: str) -> int:
    dev = torch.device("cuda")
    builds = {("K4", k): f for k, f in K4_VARIANTS.items()}
    builds.update({("K7", k): f for k, f in K7_VARIANTS.items()})
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 2) as pool:
        shipped = [pool.submit(_build.build, src) for src in ("treeadd.cu", "decompress.cu")]
        jobs = {name: pool.submit(build, *name, flags, workdir) for name, flags in builds.items()}
        for job in shipped:
            job.result()
        built = {name: job.result() for name, job in jobs.items()}
    libs = {key: lib for (_, key), (lib, _) in built.items()}
    print(json.dumps({"ptxas": {f"{kernel} {key}": records
                                for (kernel, key), (_, records) in built.items()}}), flush=True)

    rs = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = ed25519.fixed_base_table(dev)
    tables = {key: zero_entry_table(table) if key == "zero_entry" else table
              for key in K4_VARIANTS}
    s_all = torch.tensor(rs.integers(0, 256, (max(K4_LANES), 32), dtype=np.uint8), device=dev)
    k4_inputs = [(f"random {S}", s_all[:S].contiguous()) for S in K4_LANES]
    k4_inputs.append(("config #3 S 65536", config3_s(dev, 65_536)))
    for label, s in k4_inputs:
        want = treeadd.fixed_base_fold(s, table)
        fns = {}
        for key in K4_VARIANTS:
            for threads in (1,) if key.startswith("ref10") else treeadd.THREADS:
                run = k4_runner(libs[key], s, tables[key], threads, stream)
                got = run()
                torch.cuda.synchronize()
                same = (torch.equal(ed25519.compress(got), ed25519.compress(want))
                        if key.startswith("ref10") else torch.equal(got, want))
                if not same:
                    raise RuntimeError(f"K4 {key} at {threads} threads differs on {label}")
                fns[f"{key} T{threads}"] = run
        fns["shipped"] = lambda s=s: treeadd.fixed_base_fold(s, table)
        print(json.dumps({"kernel": "K4", "inputs": label, "lanes": s.shape[0],
                          "shipped_threads": treeadd.threads_per_lane(s.shape[0]),
                          "ms": rounds(fns)}), flush=True)

    enc_all = torch.tensor(rs.integers(0, 256, (max(K7_LANES), 32), dtype=np.uint8), device=dev)
    for N in K7_LANES:
        enc = enc_all[:N].contiguous()
        want = decompress.decompress(enc)
        fns = {}
        for key in K7_VARIANTS:
            run = k7_runner(libs[key], enc, stream)
            got = run()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"K7 {key} differs at {N} lanes")
            fns[key] = run
        fns["shipped"] = lambda enc=enc: decompress.decompress(enc)
        print(json.dumps({"kernel": "K7", "inputs": f"random {N}", "lanes": N,
                          "ms": rounds(fns)}), flush=True)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
