#!/usr/bin/env python3
"""Time K3'' (``ops/csrc/scalar_mult.cu``) and K5' (``sha512_kernel`` in
``ops/csrc/sha512_modl.cu``) on one CUDA card beside variants of their
designs, and count their SASS instructions.

    python3 scripts/k3ppk5p_variants.py [--seed N] [--sass-only] [--sass-dir DIR]

The variants build from this script's own sources,
``scripts/k3ppk5p_variants/scalar_mult_variants.cu`` and
``sha512_variants.cu`` (one nvcc each, in parallel, against the shipped
sources and headers; a variant number a launch), listed with what each
changes in those files' headers and in K3PP_VARIANTS / K5P_VARIANTS
below.  The shipped kernels ship one design each: ``shipped`` times the
wrapper, ``shipped_raw`` the shipped library's launch alone (ctypes, the
output allocated once).  Shapes: K3'' at 65 536 lanes with 256-bit k
(the ladder / pow path's) and 3 000 lanes with 512-bit k (the
reference's h width), points [s]B from K4 (Z != 1), k random but for
lane 0 (k = 0) and lane 1 (all ones); K5' at 1, 1 056 and 20 480 lanes of
one block (32-byte messages: the signer's SHA-512(sk), 20 480 the
setup's width); K5, which shares the compression, at 20 480 and 65 536
lanes of 80-byte messages.  Every output is held bit-equal to the shipped
kernel's, and the shipped kernel's to its plain version's.

Times are CUDA-event means of 10 launches after a warm one, three rounds
in alternating order, twice: as launched (``ms``) and queued behind a
spin (``device_ms``, ``chip_smoke.time_cuda(..., queued=True)``: the
card's own time); ``empty_ms`` is an empty kernel's queued launch, and
the ``glue`` line times the host code before K5' on the device-sign
setup (``crypto/sha512.py``'s ``_message_words`` and the whole
``sha512`` call).
SASS: ``cuobjdump -sass`` of the shipped libraries and the variants',
each kernel's instructions on the integer pipes (all but moves,
branches, the uniform datapath; ``scripts/fe_sass_counts.py``'s rule).
The probes in the variant sources, straight-line code between loads and
stores, count per-step work: ``k3pp_add_probe`` one unified addition and
``k3pp_dbl_probe`` one doubling by squarings, 2d's limbs opaque, each
less its global loads and stores and ``k3pp_io_probe``'s lane index and
addresses in ``k3pp_step_ops``: the compiled steps, set beside the field
operations that ``chip_smoke.K3PP_ADD_OPS`` and ``K3PP_DBL_OPS`` count
(the lesser); ``sha512_schedule_probe`` and
``sha512_rounds_probe`` one block's message schedule and its rounds.
Prints the ptxas records, the SASS counts, one JSON line a kernel and
shape, then the card's ``nvidia-smi`` line; ``--sass-only`` prints only
the ptxas records and the counts; ``--sass-dir`` also writes each
library's SASS there.
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
from ba_tpu_torch.crypto import ed25519, sha512  # noqa: E402
from ba_tpu_torch.ops import _build, ladder, sha512_kernel  # noqa: E402
from k6k5_variants import raw_launcher, time_all  # noqa: E402
from k9k8_variants import sass_counts  # noqa: E402

VARIANT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k3ppk5p_variants")
VARIANT_SOURCES = ("scalar_mult_variants.cu", "sha512_variants.cu")
SHIPPED = ("scalar_mult.cu", "sha512_modl.cu", "treeadd.cu")
K3PP_VARIANTS = {"v13": 0, "sq": 1, "sq128": 2, "shfl": 3, "pair": 5, "pair128": 6,
                 "pair_cached": 7, "pair_mb8": 8, "shfl_mb4": 9, "shfl_opq": 10}
K5P_VARIANTS = {"v13": 0, "b64": 2, "sched": 3}
K3PP_SHAPES = ((65_536, 256), (3_000, 512))
K5P_LANES = (1, 1_056, 20_480)
K5_LANES = (20_480, 65_536)
PROBES = ("k3pp_add_probe", "k3pp_dbl_probe", "k3pp_io_probe", "sha512_schedule_probe",
          "sha512_rounds_probe")


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
    with concurrent.futures.ThreadPoolExecutor(len(SHIPPED) + len(VARIANT_SOURCES)) as pool:
        shipped = {src: pool.submit(_build.build, src) for src in SHIPPED}
        variants = {src: pool.submit(build, src, workdir) for src in VARIANT_SOURCES}
        return ({src: str(job.result()) for src, job in shipped.items()},
                {src: job.result() for src, job in variants.items()})


def emit_build(shipped: dict, variants: dict, sass_dir) -> None:
    """The ptxas records, every kernel's SASS counts and the probes' (no
    loops allowed in a probe); with ``sass_dir``, each library's SASS."""
    print(json.dumps({"ptxas_shipped": {src: chip_smoke.ptxas_records(_build.build_log.get(src, ""))
                                        for src in shipped if src != "treeadd.cu"},
                      "ptxas_variants": {src: rec for src, (_, rec) in variants.items()}}),
          flush=True)
    libs = {src: path for src, path in shipped.items() if src != "treeadd.cu"}
    libs.update({f"{src} (variants)": path for src, (path, _) in variants.items()})
    sass = {src: sass_counts(path) for src, path in libs.items()}
    probes, body = {}, {}
    for kernels in sass.values():
        for name, c in kernels.items():
            for probe in PROBES:
                if probe in name:
                    if c["loops"]:
                        raise RuntimeError(f"{probe} has loops: {c['loops']}")
                    probes[probe] = c["int_pipe"]
                    body[probe] = c["int_pipe"] - sum(c["by_opcode"].get(op, 0)
                                                      for op in ("LDG", "STG"))
    steps = {key: body[f"k3pp_{key}_probe"] - body["k3pp_io_probe"] for key in ("add", "dbl")}
    print(json.dumps({"sass": sass, "probe_int_ops": probes, "k3pp_step_ops": steps}), flush=True)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
        for src, path in libs.items():
            text = subprocess.run([cuobjdump, "-sass", path], check=True, capture_output=True,
                                  text=True).stdout
            Path(sass_dir, f"{src.split()[0]}{'.variants' if '(' in src else ''}.sass").write_text(
                text)


def int_ops_per_s(dev) -> float:
    """The card's integer-pipe instruction rate, as chip_smoke computes it."""
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            * chip_smoke.INT32_LANES_PER_SM * float(chip_smoke.smi("clocks.max.sm").split()[0])
            * 1e6)


def k3pp_inputs(rs, n: int, nbits: int, dev):
    """n points [s]B (K4, Z != 1) and n k of nbits: 0, all ones, then random."""
    pts = ed25519.fixed_base_mult(
        torch.tensor(rs.integers(0, 256, (n, 32), dtype=np.uint8), device=dev))
    bits = torch.tensor(rs.integers(0, 2, (n, nbits), dtype=np.int32), device=dev)
    bits[0] = 0
    bits[1 % n] = 1
    return pts, bits


def run_k3pp(rs, dev, lib) -> None:
    ptr = ctypes.c_void_p
    shipped = ladder._ladder_lib().ba_scalar_mult
    for n, nbits in K3PP_SHAPES:
        pts, bits = k3pp_inputs(rs, n, nbits, dev)
        words = ladder.pack_bits(bits)
        want = ladder.scalar_mult(pts, bits)
        torch.cuda.synchronize()
        if not torch.equal(want, ladder.plain_scalar_mult(pts, bits)):
            raise RuntimeError(f"K3'' differs from its plain version at {n} lanes")
        fns = {"shipped": lambda pts=pts, bits=bits: ladder.scalar_mult(pts, bits),
               "shipped_raw": raw_launcher(shipped, [ctypes.c_int] * 2 + [ptr] * 4,
                                           [n, nbits // 32, pts, words], torch.empty_like(want))}
        for key, v in K3PP_VARIANTS.items():
            fns[key] = raw_launcher(lib.ba_scalar_mult_variant, [ctypes.c_int] * 3 + [ptr] * 4,
                                    [v, n, nbits // 32, pts, words], torch.empty_like(want))
        ops = chip_smoke.k3pp_least_ops(bits)
        print(json.dumps({"kernel": "K3''", "lanes": n, "bits": nbits, "int32_ops": ops,
                          "bound_ms": ops / int_ops_per_s(dev) * 1e3,
                          **time_all(fns, want, f"{n} lanes")}), flush=True)


def run_sha(rs, dev, lib) -> None:
    ptr = ctypes.c_void_p
    for key5, lanes, nbytes_msg, width, wrapper, plain, entry, table in (
            ("K5'", K5P_LANES, 32, 64, sha512_kernel.sha512_blocks,
             sha512_kernel.plain_sha512_blocks, "ba_sha512", K5P_VARIANTS),
            ("K5", K5_LANES, 80, 32, sha512_kernel.sha512_blocks_mod_l,
             sha512_kernel.plain_sha512_blocks_mod_l, "ba_sha512_modl", {})):
        for n in lanes:
            msg = torch.tensor(rs.integers(0, 256, (n, nbytes_msg), dtype=np.uint8), device=dev)
            wh, wl, nb = sha512._message_words(msg)
            want = wrapper(wh, wl, nb)
            torch.cuda.synchronize()
            if not torch.equal(want, plain(wh, wl, nb)):
                raise RuntimeError(f"{key5} differs from its plain version at {n} lanes")
            fns = {"shipped": lambda wh=wh, wl=wl, nb=nb, f=wrapper: f(wh, wl, nb),
                   "shipped_raw": raw_launcher(getattr(sha512_kernel._lib(), entry),
                                               [ctypes.c_int] * 2 + [ptr] * 4,
                                               [n, nb, wh, wl], torch.empty_like(want))}
            for key, v in table.items():
                fns[key] = raw_launcher(lib.ba_sha512_variant, [ctypes.c_int] * 3 + [ptr] * 4,
                                        [v, n, nb, wh, wl], torch.empty_like(want))
            ops = n * nb * chip_smoke.SHA_BLOCK_OPS
            print(json.dumps({"kernel": key5, "lanes": n, "blocks": nb, "int32_ops": ops,
                              "bound_ms": ops / int_ops_per_s(dev) * 1e3,
                              **time_all(fns, want, f"{n} lanes")}), flush=True)


def run_glue(rs, dev) -> None:
    """The host glue before K5' on the device-sign setup: ``sha512.
    _message_words`` (its torch ops and its fill_ loop) on the setup's
    20 480 secret keys, and the whole ``sha512.sha512`` call, three rounds
    each as launched (``ms``: the host's cost) and queued (``device_ms``)."""
    sk = torch.tensor(rs.integers(0, 256, (K5P_LANES[-1], 32), dtype=np.uint8), device=dev)
    fns = {"message_words": lambda: sha512._message_words(sk),
           "sha512_call": lambda: sha512.sha512(sk)}
    print(json.dumps({"glue": "K5' on the device-sign setup", "lanes": K5P_LANES[-1],
                      **{kind: {k: [chip_smoke.time_cuda(f, 10, queued=kind == "device_ms")
                                    for _ in range(3)] for k, f in fns.items()}
                         for kind in ("ms", "device_ms")}}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sass-only", action="store_true")
    parser.add_argument("--sass-dir", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3ppk5p_variants: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as workdir:
        shipped, variants = build_all(workdir)
        emit_build(shipped, variants, args.sass_dir)
        if not args.sass_only:
            dev = torch.device("cuda")
            rs = np.random.default_rng(args.seed)
            k3pp_lib = ctypes.CDLL(variants["scalar_mult_variants.cu"][0])
            empty = k3pp_lib.ba_empty
            empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
            stream = torch.cuda.current_stream(dev).cuda_stream
            print(json.dumps({"empty_ms": [chip_smoke.time_cuda(lambda: empty(stream), 10,
                                                                queued=True)
                                           for _ in range(3)]}), flush=True)
            run_sha(rs, dev, ctypes.CDLL(variants["sha512_variants.cu"][0]))
            run_glue(rs, dev)
            run_k3pp(rs, dev, k3pp_lib)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
