"""``python -m ba_tpu_torch.search <command> ...`` — the search CLI (the
port's counterpart of ``python -m ba_tpu.search``).

Three subcommands; ``sample`` and ``corpus`` load no torch (the spec
grammar, the generator and the corpus are numpy and the stdlib only),
so they cost milliseconds; ``hunt`` drives the engine and is the one
subcommand that loads torch.

- ``sample <space.json> [--seed N] [--count K]`` — print K sampled
  candidate campaigns (their ordinary spec-JSON docs) for a search
  space, deterministically.  The dry-run view of what a hunt would
  sweep.
- ``corpus <dir>`` — validate a found-reproducer corpus: every spec
  loads, validates, round-trips byte-stably, and carries the
  ``provenance.search`` replay recipe.  Exits non-zero naming the
  first offender.
- ``hunt <space.json> [--seed N] [--generations G] [--objective NAME]
  [--export DIR] [--checkpoint PATH] [--resume PATH]
  [--stop-after N] [--device DEV]`` — run a hunt (on the card unless
  ``--device cpu``) and print one JSON summary line
  (found/minimized/exported counts, best score, run_id).

Search-space JSON is :func:`ba_tpu_torch.search.generate.space_from_dict`'s
grammar: ``{"rounds": R, "capacity": n, "population": B, ...}``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ba_tpu_torch.scenario.spec import ScenarioError, to_dict
from ba_tpu_torch.search.corpus import load_corpus
from ba_tpu_torch.search.generate import sample_campaign, space_from_dict


def _load_space(path: str):
    with open(path) as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise ScenarioError(f"{path}: not valid JSON ({e})") from None
    return space_from_dict(doc)


def _cmd_sample(args) -> int:
    space = _load_space(args.space)
    for i in range(args.count):
        campaign = sample_campaign(space, args.seed, i)
        print(json.dumps(to_dict(campaign)))
    return 0


def _cmd_corpus(args) -> int:
    specs = load_corpus(args.dir)
    for spec in specs:
        search = spec.provenance["search"]
        print(
            f"{spec.name}: OK — {len(spec.events)} event(s), "
            f"objective {search['objective']!r} score {search['score']} "
            f"(seed {search['seed']}, uid {search['uid']}, "
            f"gen {search['generation']})"
        )
    print(f"corpus OK ({len(specs)} reproducer(s))")
    return 0


def _cmd_hunt(args) -> int:
    # The one torch-loading subcommand: resolved here so that sample and
    # corpus stay torch-free.
    from ba_tpu_torch.search.loop import hunt

    kwargs = dict(
        seed=args.seed,
        generations=args.generations,
        objective=args.objective,
        stop_after=args.stop_after,
        export_dir=args.export,
        checkpoint_path=args.checkpoint,
        device=args.device,
    )
    # A space file given alongside --resume passes through so hunt()'s
    # space-conflict guard engages (the checkpoint's space governs; a
    # DIFFERENT file must refuse loudly, never be silently dropped).
    space = _load_space(args.space) if args.space else None
    out = hunt(space, resume=args.resume, **kwargs)
    print(
        json.dumps(
            {
                "found": out["stats"]["found"],
                "minimized": out["stats"]["minimized"],
                "exported": out["exported"],
                "best_score": out["stats"]["best_score"],
                "campaigns": out["stats"]["campaigns"],
                "generations": out["stats"]["generations_run"],
                "run_id": out["stats"]["run_id"],
            }
        )
    )
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ba_tpu_torch.search", description=__doc__
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("sample", help="print sampled candidate campaigns")
    p.add_argument("space")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--count", type=int, default=4)
    p.set_defaults(fn=_cmd_sample)

    p = sub.add_parser("corpus", help="validate a found-reproducer corpus")
    p.add_argument("dir")
    p.set_defaults(fn=_cmd_corpus)

    p = sub.add_parser("hunt", help="run an adversary hunt (loads torch)")
    p.add_argument("space", nargs="?", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--generations", type=int, default=4)
    p.add_argument("--objective", default="ic")
    p.add_argument("--stop-after", type=int, default=None)
    p.add_argument("--export", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--device", default=None)
    p.set_defaults(fn=_cmd_hunt)

    args = parser.parse_args(argv)
    if args.command == "hunt" and not args.space and not args.resume:
        print("hunt needs a space file or --resume", file=sys.stderr)
        return 2
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:  # ScenarioError is a ValueError
        print(f"FAIL — {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
