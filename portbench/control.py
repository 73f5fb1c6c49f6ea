"""The control of a cell's comparison: the reference with one guarantee of
the configuration broken, put in the program's place, on the samples a
run would compare.  It has to come out as not correct.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

- ``om1_sweep.plain``: the quorum relaxed from 3f+1 to a simple majority;
- ``om1_failover.crash``: no re-election, a dead leader keeps leading;
- ``sm3_fused.tables``: the signature gate dropped, a value counting
  whether or not its signature verified.

Per seed it sets the cell up at its own size (no timed window), takes the
first ``--campaigns`` campaigns as the kept ones, and prints one JSON line:
the numbers the comparison checks, each as the control reads them.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(cell: dict, seed: int, device, engine: str, campaigns: int) -> dict:
    """{number: the control's reading} for ``cell`` under ``seed``."""
    from portbench import harness

    driver = harness.load_driver(cell["traffic"]["driver"])(
        cell["config"], cell["traffic"], seed, device, engine)
    driver.setup()
    plan = driver.plan(list(range(campaigns)))
    driver.prepare(plan)
    driver.release()
    got = driver.reference_sample(plan, control=True)
    want = driver.reference_sample(plan)
    return harness.mismatches(got, want)[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--campaigns", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        readings = control_readings(cell, seed, "cuda", "cuda", args.campaigns)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
