#!/usr/bin/env python3
"""Count the SASS instructions of one GF(2^255 - 19) multiply and one
squaring as the port's Ed25519 kernels compile them
(``ba_tpu_torch/ops/csrc/ed25519_field.cuh``), and time each on the card.

    python3 scripts/fe_sass_counts.py [--lanes N] [--iters N]

Needs ``nvcc``, ``cuobjdump`` and a CUDA card.  It builds a probe with
``ops/_build.py``'s flags: two kernels, one lane a thread, each a loop of
CHAINS independent chains of ``fe_mul`` (or ``fe_sq``), so that latency
hides as in the kernels.  It finds each loop's body in ``cuobjdump
-sass`` (the instructions from the backward branch's target to the
branch), counts them by opcode, and times ``iters`` rounds at ``lanes``
lanes by CUDA events.  It prints one JSON object: per operation the
instructions a multiply (or squaring), those on the multiply-add pipe
(IMAD and IMUL forms), those on the integer pipes (all but moves,
branches and the uniform datapath), the milliseconds, and the rate the
integer-pipe instructions reach per SM per clock, against the 64 the
int32 bound assumes — the numbers behind ``chip_smoke.py``'s operation
bounds for the Ed25519 kernels.  A third loop multiplies by a
loop-invariant operand (the probe P's pattern), which the compiler
turns into 64-bit products.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ba_tpu_torch.ops import _build  # noqa: E402

CHAINS = 4
PROBE = r"""
#include "ed25519_field.cuh"
#define CHAINS %d
#define LOOP(NAME, OP)                                                              \
__global__ void __launch_bounds__(64) NAME(int n, int iters, const fe* in, fe* out) { \
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;                         \
    if (lane >= n) return;                                                          \
    fe b = in[lane], a[CHAINS];                                                     \
    _Pragma("unroll") for (int c = 0; c < CHAINS; c++) { a[c] = b; a[c].v[1] += c; } \
    _Pragma("unroll 1") for (int i = 0; i < iters; i++) {                           \
        _Pragma("unroll") for (int c = 0; c < CHAINS; c++) OP;                      \
    }                                                                               \
    fe s = a[0];                                                                    \
    _Pragma("unroll") for (int c = 1; c < CHAINS; c++) fe_add(s, s, a[c]);          \
    out[lane] = s;                                                                  \
}                                                                                   \
extern "C" int NAME##_launch(int n, int iters, const void* in, void* out) {         \
    NAME<<<(n + 63) / 64, 64>>>(n, iters, (const fe*)in, (fe*)out);                 \
    return (int)cudaGetLastError();                                                 \
}
LOOP(mul_loop, fe_mul(a[c], a[c], a[(c + 1) %% CHAINS]))
LOOP(sq_loop, fe_sq(a[c], a[c]))
LOOP(hoisted_mul_loop, fe_mul(a[c], a[c], b))
""" % CHAINS

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# moves, branches and the uniform datapath (U...) issue outside the integer
# pipes that bound the field arithmetic
NOT_INT_PIPE = ("MOV", "BRA", "EXIT", "NOP")
TARGET = re.compile(r"(0x[0-9a-f]+)|`\((\.L_x_\d+)\)")


def loop_body(sass: str, kernel: str) -> list:
    """The opcodes of the body of ``kernel``'s backward branch."""
    m = re.search(rf"Function : _Z{len(kernel)}{kernel}\w*", sass)
    if m is None:
        raise RuntimeError(f"{kernel} is not in the SASS")
    text = sass[m.start():]
    nxt = text.find("Function :", 10)
    text = text if nxt < 0 else text[:nxt]
    instrs, labels, pending = [], {}, []
    for line in text.splitlines():
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instrs.append((addr, m.group(3), m.group(4)))
    for addr, op, rest in instrs:
        t = TARGET.search(rest) if op.startswith("BRA") else None
        if t:
            target = int(t.group(1), 16) if t.group(1) else labels.get(t.group(2))
            if target is not None and target < addr:
                return [o for a, o, _ in instrs if target <= a <= addr]
    raise RuntimeError(f"no loop found in {kernel}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, default=131_072)
    parser.add_argument("--iters", type=int, default=256)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fe_sass_counts: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "fe_probe.cu"
        lib_path = Path(tmp) / "fe_probe.so"
        src.write_text(PROBE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib_path), str(src)], check=True, capture_output=True)
        cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                              capture_output=True, text=True).stdout
        lib = ctypes.CDLL(str(lib_path))
        dev = torch.device("cuda")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock_hz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.split()[0]) * 1e6
        x = torch.randint(-2**24, 2**24, (args.lanes, 10), dtype=torch.int32, device=dev)
        out = torch.empty_like(x)
        result = {}
        for op, kernel in (("fe_mul", "mul_loop"), ("fe_sq", "sq_loop"),
                           ("fe_mul_by_invariant", "hoisted_mul_loop")):
            body = loop_body(sass, kernel)
            launch = getattr(lib, f"{kernel}_launch")
            launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            run = lambda: launch(args.lanes, args.iters, x.data_ptr(), out.data_ptr())  # noqa: E731
            check = run()
            torch.cuda.synchronize()
            if check:
                raise RuntimeError(f"{kernel} launch failed: CUDA error {check}")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            by_op = collections.Counter(body)
            fma = sum(n for o, n in by_op.items() if o.split(".")[0] in ("IMAD", "IMUL"))
            other_pipes = sum(n for o, n in by_op.items() if o.split(".")[0] in NOT_INT_PIPE
                              or o.startswith("U"))
            executed = (len(body) - other_pipes) * args.iters * args.lanes
            result[op] = {
                "instructions": len(body) / CHAINS, "fma_pipe": fma / CHAINS,
                "int_pipes": (len(body) - other_pipes) / CHAINS,
                "by_opcode": {o: n / CHAINS for o, n in sorted(by_op.items())},
                "ms": ms, "ops": CHAINS * args.iters * args.lanes,
                "int_pipe_instr_per_sm_clock": executed / (ms * 1e-3) / sms / clock_hz,
            }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"chains": CHAINS, "lanes": args.lanes, "iters": args.iters, "sms": sms,
                      "clock_mhz": clock_hz / 1e6, **result,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
