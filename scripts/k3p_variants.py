#!/usr/bin/env python3
"""Time K3''s ladder leg (``ops/csrc/window_mult.cu``, a 32-byte k) and K3
(``window_verify.cu``) on one CUDA card beside variants of their shared
accumulator (``window.cuh``), on three sets of inputs.

    python3 scripts/k3p_variants.py [--lanes N]

Variants, each K3''s 32-byte per-lane kernel (one nvcc each, in
parallel; each instance's registers, spill, stack frame and shared
memory from ``chip_smoke.ptxas_records``).  From this checkout's
``window.cuh``: ``signed3_shared`` is the shipped design (signed 3-bit
windows, [1..4]P cached in shared memory, 20 kB a 32-lane block, 86
windows) under the kernels' ``__launch_bounds__(32)``, and beside it
under ``(32, 1)`` and ``(32, 10)``; ``signed4_shared`` signed 4-bit
windows ([1..8]P, 40 kB a block, 64 windows); ``signed4_local`` the same
with its table in a local array (STRIDE 1).  ``unsigned16_local`` is the accumulator the kernels ran
before ``window.cuh`` was redesigned (unsigned 4-bit windows, the 16
multiples indexed in local memory), copied here.  Beside them the shipped
``ladder.window_mult`` and K3 (``ladder.window_verify``).  Inputs:
"random" is 4096 points [s]B (K4, Z != 1) and random 32-byte scalars, as
chip_smoke's ladder / pow phase makes them, tiled to N lanes; "64 keys"
puts 64 commander keys each on 64 consecutive lanes, as BASELINE config #3
lays its verify lanes out, with the same scalars; "config #3" is that
phase's own first ladder input: those keys and h = SHA-512(R || A || M)
mod L of its signed broadcasts (``signed.sign_received`` on
``default_rng(2)``'s values), whose lanes repeat few scalars a warp.  Each
line counts the distinct scalars a warp.  The variants' outputs are held
equal to ``window_mult``'s projectively: the chains give other projective
coordinates of the same points.
Times are CUDA-event means of 10 launches after a warm one, three rounds
in alternating order.  Prints one JSON line an input set, then the
card's ``nvidia-smi`` line.
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
from ba_tpu_torch.crypto import ed25519, sha512, signed  # noqa: E402
from ba_tpu_torch.ops import _build, decompress, ladder  # noqa: E402

LAUNCH = r"""
extern "C" int run(int n, const void* pt, const void* k, void* out, void* stream) {
    ladder32<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)pt, (const uint8_t*)k, (uint8_t*)out);
    return (int)cudaGetLastError();
}
"""
KERNEL = r"""
#include "window.cuh"
__global__ void __launch_bounds__(BOUNDS) ladder32(int n, const uint8_t* __restrict__ pt,
                                                   const uint8_t* __restrict__ k,
                                                   uint8_t* __restrict__ out) {
    TABLE
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ge p, acc;
    ge_frombytes4(p, pt + 128 * (size_t)lane);
    window_acc<32, WBITS, STRIDE>(acc, p, k + 32 * (size_t)lane, TAB);
    ge_tobytes4(out + 128 * (size_t)lane, acc);
}
""" + LAUNCH
SHARED = "__shared__ int32_t tab[WindowTable<WBITS>::WORDS * 32];"
LOCAL = "int32_t tab[WindowTable<WBITS>::WORDS];"
# The accumulator before window.cuh's redesign: the 16 multiples T[j] = [j]P
# (14 additions) indexed by the unsigned 4-bit digit, so in local memory; 64
# windows of 4 doublings and an addition of T[d].
UNSIGNED16 = r"""
#include "ed25519_field.cuh"
__global__ void __launch_bounds__(32, 1) ladder32(int n, const uint8_t* __restrict__ pt,
                                                  const uint8_t* __restrict__ k,
                                                  uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const uint8_t* kk = k + 32 * (size_t)lane;
    ge p, acc, tab[16];
    ge_frombytes4(p, pt + 128 * (size_t)lane);
    ge_identity(tab[0]);
    tab[1] = p;
#pragma unroll 1
    for (int j = 2; j < 16; j++) ge_add(tab[j], tab[j - 1], tab[1]);
    ge_identity(acc);
#pragma unroll 1
    for (int w = 63; w >= 0; w--) {
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, true);
        ge_add(acc, acc, tab[(kk[w >> 1] >> (4 * (w & 1))) & 15]);
    }
    ge_tobytes4(out + 128 * (size_t)lane, acc);
}
""" + LAUNCH


# name -> (window bits, where the table lives, launch bounds)
SIGNED = {"signed3_shared": ("3", "shared", "32"),
          "signed3_shared_b1": ("3", "shared", "32, 1"),
          "signed3_shared_b10": ("3", "shared", "32, 10"),
          "signed4_shared": ("4", "shared", "32, 1"),
          "signed4_local": ("4", "local", "32, 1")}
VARIANTS = (*SIGNED, "unsigned16_local")


def source(name: str) -> str:
    if name == "unsigned16_local":
        return UNSIGNED16
    wbits, where, bounds = SIGNED[name]
    shared = where == "shared"
    return (KERNEL.replace("TABLE", SHARED if shared else LOCAL)
            .replace("TAB", "tab + threadIdx.x" if shared else "tab")
            .replace("STRIDE", "32" if shared else "1")
            .replace("BOUNDS", bounds).replace("WBITS", wbits))


def build(name: str, workdir: str):
    src = os.path.join(workdir, f"{name}.cu")
    lib = os.path.join(workdir, f"{name}.so")
    with open(src, "w") as f:
        f.write(source(name))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    return fn, chip_smoke.ptxas_records(proc.stdout + proc.stderr)


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


def same_points(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(ed25519.point_eq(ed25519.decode_point(a), ed25519.decode_point(b)).all())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, default=65_536)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3p_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    S = args.lanes
    with tempfile.TemporaryDirectory() as workdir, \
            concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 4) as pool:
        jobs = {name: pool.submit(build, name, workdir) for name in VARIANTS}
        shipped = [pool.submit(_build.build, s) for s in ("window_mult.cu", "window_verify.cu",
                                                           "treeadd.cu", "decompress.cu",
                                                           "sha512_modl.cu")]
        built = {name: job.result() for name, job in jobs.items()}
        for job in shipped:
            job.result()
        print(json.dumps({"ptxas": {name: p for name, (_, p) in built.items()}}), flush=True)

        rs = np.random.default_rng(0)
        tile = -(-S // 4096)
        k = torch.tensor(rs.integers(0, 256, (4096, 32), dtype=np.uint8), device=dev)
        pts = ed25519.fixed_base_mult(
            torch.tensor(rs.integers(0, 256, (4096, 32), dtype=np.uint8), device=dev))
        k = k.repeat(tile, 1)[:S].contiguous()
        random_pts = pts.repeat(tile, 1, 1)[:S].contiguous()
        sks, pks = signed.commander_keys(64)
        pk_rows = torch.tensor(np.repeat(pks, 64, axis=0), device=dev).repeat(tile, 1)[:S]
        key_pts = decompress.decompress(pk_rows.contiguous())[0]
        msgs, sigs = signed.sign_received(sks, pks,
                                          np.random.default_rng(2).integers(0, 2, (64, 64)))
        rows = lambda a: torch.tensor(  # noqa: E731
            np.ascontiguousarray(a.reshape(4096, -1)), device=dev).repeat(tile, 1)[:S]
        h = sha512.sha512_mod_l(torch.cat([rows(sigs)[:, :32], pk_rows, rows(msgs)], dim=1))
        stream = torch.cuda.current_stream(dev).cuda_stream
        for label, p, kk in (("random", random_pts, k), ("64 keys", key_pts, k),
                             ("config #3", key_pts, h.contiguous())):
            distinct = float(np.mean([len({bytes(r) for r in w})
                                      for w in kk.cpu().numpy().reshape(-1, 32, 32)]))
            want = ladder.window_mult(p, kk)
            fns = {}
            for name, (run, _) in built.items():
                out = torch.empty_like(want)

                def launch(run=run, out=out):
                    if run(S, p.data_ptr(), kk.data_ptr(), out.data_ptr(), stream) != 0:
                        raise RuntimeError("launch failed")
                launch()
                torch.cuda.synchronize()
                ok = same_points(out, want)
                if not ok:
                    raise RuntimeError(f"{name} differs from window_mult on {label}")
                fns[name] = launch
            fns["window_mult"] = lambda: ladder.window_mult(p, kk)
            fns["K3"] = lambda: ladder.window_verify(p, kk, p, want)
            times = {name: [] for name in fns}
            for r in range(3):
                for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    times[name].append(mean_ms(fns[name]))
            print(json.dumps({"inputs": label, "lanes": S, "distinct_scalars_a_warp": distinct,
                              "ms": times}), flush=True)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
