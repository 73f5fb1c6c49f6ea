#!/usr/bin/env python3
"""Time BASELINE config #3 on one CUDA card in two checkouts of the port,
in alternating pairs, so that two versions are compared within one machine.

    python3 scripts/torch_checkout_ab.py DIR_A DIR_B [--pairs N] [--out FILE]

Each run is a fresh process in the checkout's directory that imports that
checkout's ``chip_smoke.py`` and runs its build phase and its config #3
phase (``phase_config3``: the per-signature verify, the batch verify, the
ladder leg and the probe at 65 536 lanes, then the exact SM(1) round).
Pair i runs A then B when i is even, B then A when it is odd (N = 2 is
A B B A).  Prints one JSON line a run (the phase's rates and its one-call
host and card times, with the checkout's label), then a summary line: for
each rate and each one-call time, both medians, the spread between A's
quartiles, the pairs B won, the card's name and power limit.  ``--out``
also writes every run's phase lines to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = (
    "import torch, chip_smoke as cs\n"
    "dev = torch.device('cuda')\n"
    "cs.phase_env(dev)\n"
    "cs.phase_config3(dev, cs.smi('name,power.limit'))\n"
)
RATES = ("ed25519_verifies_per_sec", "rlc_batch_verifies_per_sec", "sm1_rounds_per_sec")
TIMES = ("verify_host_queue_ms", "verify_card_ms", "rlc_host_queue_ms", "rlc_card_ms")


def run_once(directory: str) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=directory, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{directory}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def reading(lines: list[dict]) -> dict:
    phase = next(ln for ln in lines if ln.get("phase") == "config3_sm1_n64_signed")
    row = {k: phase[k] for k in RATES}
    for leg in ("verify", "rlc"):
        row[f"{leg}_host_queue_ms"] = phase["one_call"][leg]["host_queue_ms"]
        row[f"{leg}_card_ms"] = phase["one_call"][leg]["card_ms"]
    row["card"] = phase["card"]
    return row


def summary(pairs: list[dict]) -> dict:
    out = {}
    for key, higher_wins in [(k, True) for k in RATES] + [(k, False) for k in TIMES]:
        a = [p["A"][key] for p in pairs]
        b = [p["B"][key] for p in pairs]
        qa = statistics.quantiles(a, n=4) if len(a) > 1 else [a[0]] * 3
        out[key] = {"median_a": statistics.median(a), "median_b": statistics.median(b),
                    "a_quartile_spread": qa[2] - qa[0],
                    "b_wins": sum((y > x) if higher_wins else (y < x) for x, y in zip(a, b)),
                    "pairs": len(pairs)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    dirs = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    runs, pairs = [], []
    for i in range(args.pairs):
        pair = {}
        for label in ("A", "B") if i % 2 == 0 else ("B", "A"):
            lines = run_once(dirs[label])
            pair[label] = reading(lines)
            print(json.dumps({"pair": i, "label": label, **pair[label]}), flush=True)
            runs.append({"pair": i, "label": label, "lines": lines})
        pairs.append(pair)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(runs, fh)
    print(json.dumps({"summary": summary(pairs), "dirs": dirs, "card": pairs[-1]["A"]["card"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
