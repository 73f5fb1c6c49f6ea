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
- ``serving``: the checkout's own ``chip_smoke.py``'s phase 17
  (``phase_coalesced_serving``: bench_serving's 32 requests alone and in
  cohorts of 8 through ``coalesced_sweep``) three times, the reading the
  median requests/s of each leg, then its phase 18
  (``phase_coalesced_full_width``), the reading its wall;
- ``repl``: ``ab_repl`` of the ``chip_smoke.py`` beside this script,
  loaded alike: the REPL's ``run-rounds attack 1024`` on a roster of 1 000
  generals (128 K1 dispatches at B = 1) seven times after a warm-up, the
  reading the median wall;
- ``supervised``: ``ab_supervised`` of the ``chip_smoke.py`` beside this
  script, loaded alike: the REPL's B = 1 ``run-rounds`` shape (128 K1
  dispatches of 8 rounds) without checkpoints through ``pipeline_sweep``
  alone, with its watchdog or a seam alone, and through
  ``supervised_sweep``, in rotation, the readings the unsupervised and
  supervised medians, their ratio and both minima;
- any other PHASE names a group of ``chip_smoke.AB_GROUPS``, run by
  ``ab_kernels`` of the same ``chip_smoke.py``, loaded alike: the group's
  sources built alone, then by CUDA events each of its readings in
  ``AB_ROWS`` (a wrapper on inputs made from a seed), then the group's
  phases (``k9k8``: config #2's and eig_n1024's rounds/s; ``k6k5``:
  config #3's two verify rates and the device-sign setup's ``total_s``).
  The groups: ``k3p_random`` (K3' and K3 on random 256-bit k), ``k4k7``
  (K4 and K7 at the paths' lane counts), ``k9k8`` (K9 at config #2's two
  resolve levels, eig_n1024's and the m = 2 sweep's; K8 at 2 and 20 480
  lanes), ``k6k5`` (K6 at 1, 1 024, 20 480 and 65 536 lanes, K5 at 20 480
  and 65 536, K5' at 20 480, each through its wrapper and alone: the
  library's launch, timed queued behind a spin), ``k3ppk5p`` (K3'' at
  65 536 lanes of 256-bit k through its wrapper, the ladder / pow path's
  call, and alone there and at 3 000 lanes of 512-bit k; K5' at 20 480
  through its wrapper and alone; then the phases of ``k6k5``).  A new pair of kernels
  adds rows there, not code here.

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
RUNS = {
    "config3": (
        "import torch, chip_smoke as cs\n"
        "dev = torch.device('cuda')\n"
        "cs.phase_env(dev)\n"
        "cs.phase_config3(dev, cs.smi('name,power.limit'))\n"
    ),
    "sweeps": LOAD_BESIDE + "cs.ab_sweeps(torch.device('cuda'), cs.smi('name,power.limit'))\n",
    "repl": LOAD_BESIDE + "cs.ab_repl(torch.device('cuda'), cs.smi('name,power.limit'))\n",
    "supervised": (LOAD_BESIDE
                   + "cs.ab_supervised(torch.device('cuda'), cs.smi('name,power.limit'))\n"),
    "serving": (
        "import torch, chip_smoke as cs\n"
        "dev, card = torch.device('cuda'), cs.smi('name,power.limit')\n"
        "for _ in range(3):\n"
        "    cs.phase_coalesced_serving(dev, card)\n"
        "cs.phase_coalesced_full_width(dev, 0, card)\n"
    ),
}
# (reading, True where higher wins); a group's come with its line
READINGS = {
    "config3": [("ed25519_verifies_per_sec", True), ("rlc_batch_verifies_per_sec", True),
                ("sm1_rounds_per_sec", True), ("verify_host_queue_ms", False),
                ("verify_card_ms", False), ("rlc_host_queue_ms", False),
                ("rlc_card_ms", False), ("rlc_gc_ms", False), ("rlc_cuda_mallocs", False)],
    "sweeps": [("plain_sweep_rounds_per_s", True), ("scenario_rounds_per_s", True),
               ("coalesced_slot_rounds_per_s", True), ("signed_sweep_rounds_per_s", True),
               ("k1_plain_ms", False), ("k1_scenario_ms", False), ("k1_slot_ms", False),
               ("k1_plain_n1000_ms", False), ("k2_step_ms", False)],
    "serving": [("alone_requests_per_s", True), ("coalesced_requests_per_s", True),
                ("full_width_wall_s", False)],
    "repl": [("run_rounds_s", False)],
    "supervised": [("median_unsupervised_s", False), ("median_supervised_s", False),
                   ("ratio_of_medians", False), ("min_unsupervised_s", False),
                   ("min_supervised_s", False)],
}


def command(phase: str) -> str:
    if phase in RUNS:
        return RUNS[phase]
    return (LOAD_BESIDE + "cs.ab_kernels(torch.device('cuda'), cs.smi('name,power.limit'), "
            f"{phase!r})\n")


def run_once(directory: str, phase: str) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", command(phase)], cwd=directory,
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
    if phase == "serving":
        legs = [ln for ln in lines if ln.get("phase") == "coalesced_serving"]
        return {**{key: statistics.median(ln[key] for ln in legs)
                   for key in ("alone_requests_per_s", "coalesced_requests_per_s")},
                "full_width_wall_s": by["coalesced_full_width"]["wall_s"],
                "card": by["coalesced_full_width"]["card"]}
    if phase == "repl":
        return {"run_rounds_s": by["ab_repl"]["run_rounds_s"], "card": by["ab_repl"]["card"]}
    if phase == "supervised":
        line = by["ab_supervised"]
        return {key: line[key] for key, _ in READINGS["supervised"]} | {"card": line["card"]}
    if phase not in RUNS:  # a group of chip_smoke.AB_GROUPS
        line = by[f"ab_{phase}"]
        row = dict(line["readings"])
        for key, (name, field) in line["from_lines"].items():
            row[key] = by[name][field]
        READINGS.setdefault(phase, [(key, key in line["higher_wins"]) for key in row])
        return row | {"card": line["card"]}
    k = by["ab_sweeps"]
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
    parser.add_argument("--phase", default="config3",
                        help="config3, sweeps, serving, repl, supervised, or a group of "
                             "chip_smoke.AB_GROUPS")
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
