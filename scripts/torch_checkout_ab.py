#!/usr/bin/env python3
"""Time one phase of ``chip_smoke.py`` on one CUDA card in two checkouts of
the port, in alternating pairs, so that two versions are compared within
one machine.

    python3 scripts/torch_checkout_ab.py DIR_A DIR_B [--phase PHASE] [--pairs N]
                                         [--out FILE]

Each run is a fresh process in the checkout's directory, so that it
imports that checkout's package, and runs one of:

- ``config3`` (the default): the checkout's own ``chip_smoke.py``'s build
  phase and config #3 phase
  (``phase_config3``: the per-signature verify, the batch verify, the
  ladder leg and the probe at 65 536 lanes, then the exact SM(1) round);
- ``sweeps``: ``ab_sweeps`` of the ``chip_smoke.py`` beside this script,
  loaded by path in each checkout's process, so both sides run the same
  measuring code on their own package: K1 and K2 built alone, the plain
  sweep, the coalition campaign, the full-width coalesced cohort and the
  signed sweep, and by CUDA events one full-width dispatch of K1 in each
  mode, one plain dispatch at capacity 1000 (n not a multiple of 32) and
  K2's warm-up dispatch of each bucket;
- ``k3p_random``: ``ab_k3p_random`` of the same ``chip_smoke.py``, loaded
  alike: window_mult.cu, window_verify.cu and treeadd.cu built alone, then
  by CUDA events K3' on the ladder / pow phase's kind of input (65 536
  points [s]B, random 256-bit k) and K3 on the same lanes, and on 20 480
  of them.

- ``k4k7``: ``ab_k4k7`` of the same ``chip_smoke.py``, loaded alike:
  treeadd.cu and decompress.cu built alone, then by CUDA events K4
  (``ed25519.fixed_base_mult``) on random scalars at 1, 10 240, 20 480
  and 65 536 lanes and K7 (``ed25519.decompress``) on random encodings at
  20 480, 40 960, 66 560 and 131 072.

Pair i runs A then B when i is even, B then A when it is odd (N = 2 is
A B B A).  Prints one JSON line a run (the phase's readings, with the
checkout's label), then a summary line: for each reading, both medians,
the spread between A's quartiles, the pairs B won, the card's name and
power limit.  ``--out`` also writes every run's phase lines to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHIP_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "chip_smoke.py")
LOAD_BESIDE = (
    "import importlib.util, torch\n"
    f"spec = importlib.util.spec_from_file_location('chip_smoke', {CHIP_SMOKE!r})\n"
    "cs = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(cs)\n"
)
# A checkout from before K3''s sum lacks the wrappers chip_smoke names at import.
BEFORE_SUM = (
    "from ba_tpu_torch.ops import ladder\n"
    "for name in ('window_mult_sum8', 'plain_window_mult_sum8'):\n"
    "    setattr(ladder, name, getattr(ladder, name, None))\n"
)
RUNS = {
    "config3": (
        "import torch, chip_smoke as cs\n"
        "dev = torch.device('cuda')\n"
        "cs.phase_env(dev)\n"
        "cs.phase_config3(dev, cs.smi('name,power.limit'))\n"
    ),
    "sweeps": LOAD_BESIDE + "cs.ab_sweeps(torch.device('cuda'), cs.smi('name,power.limit'))\n",
    "k3p_random": BEFORE_SUM + LOAD_BESIDE
    + "cs.ab_k3p_random(torch.device('cuda'), cs.smi('name,power.limit'))\n",
    "k4k7": LOAD_BESIDE + "cs.ab_k4k7(torch.device('cuda'), cs.smi('name,power.limit'))\n",
}
# (reading, True where higher wins)
READINGS = {
    "config3": [("ed25519_verifies_per_sec", True), ("rlc_batch_verifies_per_sec", True),
                ("sm1_rounds_per_sec", True), ("verify_host_queue_ms", False),
                ("verify_card_ms", False), ("rlc_host_queue_ms", False),
                ("rlc_card_ms", False), ("rlc_gc_ms", False), ("rlc_cuda_mallocs", False)],
    "sweeps": [("plain_sweep_rounds_per_s", True), ("scenario_rounds_per_s", True),
               ("coalesced_slot_rounds_per_s", True), ("signed_sweep_rounds_per_s", True),
               ("k1_plain_ms", False), ("k1_scenario_ms", False), ("k1_slot_ms", False),
               ("k1_plain_n1000_ms", False), ("k2_step_ms", False)],
    "k3p_random": [("k3p_random_ms", False), ("k3_random_ms", False),
                   ("k3_random_20480_ms", False)],
    "k4k7": [(f"k4_{n}_ms", False) for n in (1, 10_240, 20_480, 65_536)]
    + [(f"k7_{n}_ms", False) for n in (20_480, 40_960, 66_560, 131_072)],
}


def run_once(directory: str, phase: str) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", RUNS[phase]], cwd=directory,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{directory}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def reading(lines: list[dict], phase: str) -> dict:
    by = {ln.get("phase"): ln for ln in lines}
    if phase == "config3":
        ph = by["config3_sm1_n64_signed"]
        row = {k: ph[k] for k in ("ed25519_verifies_per_sec", "rlc_batch_verifies_per_sec",
                                  "sm1_rounds_per_sec")}
        for leg in ("verify", "rlc"):
            row[f"{leg}_host_queue_ms"] = ph["one_call"][leg]["host_queue_ms"]
            row[f"{leg}_card_ms"] = ph["one_call"][leg]["card_ms"]
        row["rlc_gc_ms"] = ph["one_call"]["rlc"].get("gc_ms", 0.0)
        row["rlc_cuda_mallocs"] = ph["one_call"]["rlc"].get("cuda_mallocs", 0)
        row["card"] = ph["card"]
        return row
    if phase in ("k3p_random", "k4k7"):
        line = by[f"ab_{phase}"]
        return {key: line[key] for key, _ in READINGS[phase]} | {"card": line["card"]}
    k = by["ab_kernels"]
    return {"plain_sweep_rounds_per_s": by["full_width_validity"]["agreement_rounds_per_s"],
            "scenario_rounds_per_s": by["scenario_full_width"]["agreement_rounds_per_s"],
            "coalesced_slot_rounds_per_s": by["coalesced_full_width"]["slot_rounds_per_s"],
            "signed_sweep_rounds_per_s":
                by["signed_sweep_full_width"]["agreement_rounds_per_s"]["best"],
            **{key: k[key] for key in ("k1_plain_ms", "k1_scenario_ms", "k1_slot_ms",
                                       "k1_plain_n1000_ms", "k2_step_ms", "k2_bucket_ms")},
            "card": k["card"]}


def summary(pairs: list[dict], phase: str) -> dict:
    out = {}
    for key, higher_wins in READINGS[phase]:
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
    parser.add_argument("--phase", choices=sorted(RUNS), default="config3")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    dirs = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    runs, pairs = [], []
    for i in range(args.pairs):
        pair = {}
        for label in ("A", "B") if i % 2 == 0 else ("B", "A"):
            lines = run_once(dirs[label], args.phase)
            pair[label] = reading(lines, args.phase)
            print(json.dumps({"pair": i, "label": label, **pair[label]}), flush=True)
            runs.append({"pair": i, "label": label, "lines": lines})
        pairs.append(pair)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(runs, fh)
    print(json.dumps({"phase": args.phase, "summary": summary(pairs, args.phase),
                      "dirs": dirs, "card": pairs[-1]["A"]["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
