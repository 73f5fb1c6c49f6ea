#!/usr/bin/env python3
"""Time K3''s ladder leg (``ops/csrc/window_mult.cu``, a 32-byte k) against
K3 (``window_verify.cu``) on one CUDA card, with K3''s per-lane body built
under other launch bounds, on three sets of inputs.

    python3 scripts/k3p_variants.py [--lanes N]

Variants: the shipped ``ladder.window_mult`` and K3 (``ladder.window_verify``,
the same 64 windows of ``window_acc`` plus its tail), and a copy of K3''s
32-byte kernel built with ``__launch_bounds__(32)``, ``(32, 1)``, ``(32,
11)`` and ``(32, 12)`` (one nvcc each, in parallel; ptxas's registers,
stack and spill printed).  Inputs: "random" is the first 4096 points and
32-byte scalars of ``chip_smoke.k3p_inputs`` tiled to N lanes;
"64 keys" puts 64 commander keys each on 64 consecutive lanes, as BASELINE
config #3 lays its verify lanes out, with the same scalars; "config #3" is
that phase's own first ladder input: those keys and h = SHA-512(R || A ||
M) mod L of its signed broadcasts (``signed.sign_received`` on
``default_rng(2)``'s values), whose lanes repeat few scalars a warp.  Each
line counts the distinct scalars a warp.  Every variant's output is held
bit-equal to ``window_mult``'s.  Times are CUDA-event means
of 10 launches after a warm one, three rounds in alternating order.
Prints one JSON line an input set, then the card's ``nvidia-smi`` line.
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
from ba_tpu_torch.crypto import sha512, signed  # noqa: E402
from ba_tpu_torch.ops import _build, decompress, ladder  # noqa: E402

KERNEL = r"""
#include "window.cuh"
__global__ void __launch_bounds__(32 BOUNDS) ladder32(int n, const uint8_t* __restrict__ pt,
                                                      const uint8_t* __restrict__ k,
                                                      uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ge p, acc;
    ge_frombytes4(p, pt + 128 * (size_t)lane);
    window_acc<32>(acc, p, k + 32 * (size_t)lane);
    ge_tobytes4(out + 128 * (size_t)lane, acc);
}
extern "C" int run(int n, const void* pt, const void* k, void* out, void* stream) {
    ladder32<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)pt, (const uint8_t*)k, (uint8_t*)out);
    return (int)cudaGetLastError();
}
"""
BOUNDS = {"bounds_32": "", "bounds_32_1": ", 1", "bounds_32_11": ", 11", "bounds_32_12": ", 12"}


def build(name: str, workdir: str):
    src = os.path.join(workdir, f"{name}.cu")
    lib = os.path.join(workdir, f"{name}.so")
    with open(src, "w") as f:
        f.write(KERNEL.replace("BOUNDS", BOUNDS[name]))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


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
            concurrent.futures.ThreadPoolExecutor(len(BOUNDS) + 2) as pool:
        jobs = {name: pool.submit(build, name, workdir) for name in BOUNDS}
        shipped = [pool.submit(_build.build, s) for s in ("window_mult.cu", "window_verify.cu")]
        built = {name: job.result() for name, job in jobs.items()}
        for job in shipped:
            job.result()
        print(json.dumps({"ptxas": {name: p for name, (_, p) in built.items()}}), flush=True)

        rs = np.random.default_rng(0)
        pts, k = chip_smoke.k3p_inputs(rs, 4096, 32, dev)
        tile = -(-S // 4096)
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
        for label, p, k in (("random", random_pts, k), ("64 keys", key_pts, k),
                            ("config #3", key_pts, h.contiguous())):
            distinct = float(np.mean([len({bytes(r) for r in w})
                                      for w in k.cpu().numpy().reshape(-1, 32, 32)]))
            want = ladder.window_mult(p, k)
            out = torch.empty_like(want)
            fns = {}
            for name, (run, _) in built.items():
                def launch(run=run):
                    if run(S, p.data_ptr(), k.data_ptr(), out.data_ptr(), stream) != 0:
                        raise RuntimeError("launch failed")
                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} differs from window_mult on {label}")
                fns[name] = launch
            fns["window_mult"] = lambda: ladder.window_mult(p, k)
            fns["K3"] = lambda: ladder.window_verify(p, k, p, want)
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
