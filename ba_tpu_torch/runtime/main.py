"""CLI entry point: ``python -m ba_tpu_torch.runtime.main N [--backend ...]``
(``ba_tpu/runtime/main.py``).

Launch-compatible with the reference's one-positional-arg contract
(Generals_Byzantine_program.sh:1 -> ba.py:12).  ``--backend cuda`` (the
default) runs the batched torch core on the card and exits with an error
when there is none; ``--backend torch`` runs it on the CPU; ``--backend
py`` is the sequential Python oracle.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_cluster(argv=None):
    parser = argparse.ArgumentParser(
        prog="ba-tpu-torch",
        description="Byzantine Generals simulator on PyTorch / CUDA",
    )
    parser.add_argument("n", type=int, help="initial number of generals")
    parser.add_argument(
        "--backend",
        choices=["cuda", "torch", "py"],
        default="cuda",
        help="cuda: batched torch core on the card; torch: the same on the CPU; "
        "py: sequential Python oracle",
    )
    parser.add_argument("--seed", type=int, default=0, help="fault-coin RNG seed")
    parser.add_argument(
        "-m",
        type=int,
        default=1,
        dest="m",
        help="OM recursion depth (1 = the reference's protocol)",
    )
    parser.add_argument(
        "--protocol",
        choices=["om", "sm"],
        default="om",
        help="om: oral messages (reference semantics); sm: signed messages",
    )
    parser.add_argument(
        "--signed",
        action="store_true",
        help="sm only: real Ed25519 sign/verify per round (host sign, "
        "batched verify on the backend's device)",
    )
    parser.add_argument(
        "--state",
        default=None,
        metavar="FILE",
        help="cluster snapshot: restored at startup when it exists, saved "
        "on exit (the reference loses all state on exit; SURVEY.md sec. 6)",
    )
    args = parser.parse_args(argv)

    from ba_tpu_torch.runtime.cluster import Cluster

    if args.backend == "py":
        if args.protocol != "om" or args.signed:
            parser.error(
                "--protocol sm/--signed require --backend cuda or torch "
                "(the py oracle only implements unsigned oral messages)"
            )
        from ba_tpu_torch.runtime.backends import PyBackend

        backend = PyBackend()
    else:
        from ba_tpu_torch.runtime.backends import TorchBackend

        try:
            backend = TorchBackend(
                device="cpu" if args.backend == "torch" else None,
                m=args.m,
                protocol=args.protocol,
                signed=args.signed,
            )
        except (RuntimeError, ValueError) as e:  # no card for --backend cuda
            parser.exit(1, f"{parser.prog}: error: {e}\n")
    cluster = Cluster(args.n, backend, seed=args.seed)
    if args.state and os.path.exists(args.state):
        from ba_tpu_torch.utils.snapshot import restore_cluster

        restore_cluster(args.state, cluster)
    return cluster, args.state


def main(argv=None) -> int:
    cluster, state_path = build_cluster(argv)
    from ba_tpu_torch.runtime.repl import run_repl

    try:
        run_repl(cluster, sys.stdin, print)
    finally:
        # Saved on an abnormal exit too (Ctrl-C, a backend error).
        if state_path:
            from ba_tpu_torch.utils.snapshot import save_cluster

            save_cluster(state_path, cluster)
    return 0


if __name__ == "__main__":
    sys.exit(main())
