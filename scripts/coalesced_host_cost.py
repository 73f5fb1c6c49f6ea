#!/usr/bin/env python3
"""Host cost of one ``coalesced_sweep`` call at chip_smoke's phase 17
shape (bench_serving's requests: n = 4 at capacity 4, 32 rounds 8 a
dispatch, on K1's slot mode), in one or more checkouts of the port, on
one CUDA card.

    python3 scripts/coalesced_host_cost.py DIR [DIR ...] [--rounds N] [--calls N]

Each checkout runs in processes of its own (its package imported from
its directory), the checkouts taking turns for ``--rounds`` rounds.  In
each process every variant is timed in turn, ``--calls`` calls at B = 1
and a quarter as many at B = 8, after a warm-up; the variants switch off
parts of the loop's serving bookkeeping by replacing them for the
process:

- ``as_is``: the checkout's own code;
- ``no_run_id``: ``flight.resolve_run_id`` returns a fixed id;
- ``no_instruments``: the ``pipeline_*`` instruments record nothing;
- ``neither``: both;
- ``as_is_gc_off`` / ``neither_gc_off``: the same with the garbage
  collector off during the timed calls.

A checkout without this bookkeeping (before it existed) times every
variant as ``as_is``.  Prints one JSON line a process (each variant's
mean µs a call) and a summary line of medians, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import gc, json, sys, time
import numpy as np, torch
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.parallel import pipeline

dev = torch.device("cuda")
calls = int(sys.argv[1])
CAP, R, RPD = 4, 32, 8


def reqs(B, base):
    return [((1, 0)[i % 2], ((2,), (), (1, 3))[i % 3], base + i) for i in range(B)]


def cohort(rq):
    B = len(rq)
    faulty = np.zeros((B, CAP), bool)
    for i, (_, fl, _) in enumerate(rq):
        faulty[i, list(fl)] = True
    state = SimState(order=torch.tensor([o for o, _, _ in rq], dtype=torch.int8),
                     leader=torch.zeros(B, dtype=torch.int32), faulty=torch.from_numpy(faulty),
                     alive=torch.ones((B, CAP), dtype=torch.bool),
                     ids=torch.arange(1, CAP + 1, dtype=torch.int32).repeat(B, 1))
    return pipeline.coalesced_sweep([rng.key(s, device="cpu") for _, _, s in rq], state, R,
                                    rounds_per_dispatch=RPD, engine="cuda", device=dev)


class Nop:
    def record_many(self, values):
        pass

    def inc(self, n=1):
        pass


real = {"rid": getattr(pipeline.flight, "resolve_run_id", None),
        "inst": getattr(pipeline, "_pipeline_instruments", None)}


def setup(no_rid, no_inst):
    if real["rid"] is not None:
        pipeline.flight.resolve_run_id = (
            (lambda *a, **k: "run-0000000000000000") if no_rid else real["rid"])
    if real["inst"] is not None:
        pipeline._pipeline_instruments = (
            (lambda reg: {k: Nop() for k in ("lat", "lag", "occ", "disp", "ret", "rounds",
                                              "fallbacks")}) if no_inst else real["inst"])


VARIANTS = {"as_is": (False, False, True), "no_run_id": (True, False, True),
            "no_instruments": (False, True, True), "neither": (True, True, True),
            "as_is_gc_off": (False, False, False), "neither_gc_off": (True, True, False)}
for B in (1, 8):
    for _ in range(20):
        cohort(reqs(B, 0))
out = {}
for name, (no_rid, no_inst, gc_on) in VARIANTS.items():
    setup(no_rid, no_inst)
    for B, n in ((1, calls), (8, max(1, calls // 4))):
        batches = [reqs(B, 1000 + i * B) for i in range(n)]
        cohort(batches[0])
        torch.cuda.synchronize()
        if not gc_on:
            gc.collect()
            gc.disable()
        t0 = time.perf_counter()
        for rq in batches:
            cohort(rq)
        wall = time.perf_counter() - t0
        gc.enable()
        out[f"{name}_B{B}_us"] = 1e6 * wall / n
print(json.dumps(out))
'''


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--calls", type=int, default=400)
    args = parser.parse_args(argv)
    dirs = [os.path.abspath(d) for d in args.dirs]
    runs = {d: [] for d in dirs}
    for r in range(args.rounds):
        for d in (dirs if r % 2 == 0 else dirs[::-1]):
            proc = subprocess.run([sys.executable, "-c", CHILD, str(args.calls)], cwd=d,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"{d}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[d].append(line)
            print(json.dumps({"round": r, "dir": d, **line}), flush=True)
    summary = {d: {k: statistics.median(run[k] for run in rs) for k in rs[0]}
               for d, rs in runs.items()}
    print(json.dumps({"summary_median_us": summary, "card": smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
