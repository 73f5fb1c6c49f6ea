"""``python -m ba_tpu_torch.scenario <spec.json|ckpt.npz> ...`` — the
validator for campaign specs and carry checkpoints
(``ba_tpu/scenario/__main__.py``), on the port's own copies.

For every ``.json`` path: load and validate the spec, round-trip it
through ``to_dict`` / ``from_dict``, lower it through both compilers at a
probe shape (batch 2, capacity the largest general id the events name,
at least 4), and check that the sparse lowering's JSON form round-trips
and that its chunks equal the dense planes (every chunk on small specs;
on long campaigns every chunk with events and a spread of empty ones).

For every ``.npz`` path: schema-check it as a carry checkpoint, written
by either package (``utils/snapshot.validate_carry_checkpoint``: header,
digest, carry arrays, cursor against the KeySchedule counter, counter
and strategy shapes).

Prints one line a path on stdout, the same lines as the JAX package's
validator; exits 1 with the offending path on stderr at the first
failure, 2 without arguments.  numpy and the stdlib only.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ba_tpu_torch.scenario.compile import SparseScenarioBlock, compile_scenario
from ba_tpu_torch.scenario.spec import (
    ScenarioError,
    event_rounds,
    from_dict,
    load,
    to_dict,
)
from ba_tpu_torch.utils.snapshot import validate_carry_checkpoint


def _check_spec(path: str) -> str:
    spec = load(path)
    doc = to_dict(spec)
    if to_dict(from_dict(doc)) != doc:
        raise ScenarioError("to_dict/from_dict round-trip drifted")
    capacity = max([4] + [gid for ev in spec.events for gid in ev.ids])
    sparse = compile_scenario(spec, batch=2, capacity=capacity, sparse=True)
    # The dense reference lowering is O(rounds * capacity) host memory
    # even at probe batch 2 — fine for every committed spec, but a
    # million-round campaign naming a four-digit general id would need
    # gigabytes here.  Above the cap the dense side of the parity check
    # is skipped (the sparse round-trip and chunk/bounds validation
    # still run); the output line says which mode ran.
    dense_cells = spec.rounds * 2 * capacity * 4
    block = (
        compile_scenario(spec, batch=2, capacity=capacity)
        if dense_cells <= 64_000_000
        else None
    )
    # Sparse encoding round-trip: exact through its own JSON grammar.
    sdoc = sparse.to_doc()
    if SparseScenarioBlock.from_doc(
        json.loads(json.dumps(sdoc))
    ).to_doc() != sdoc:
        raise ScenarioError("sparse to_doc/from_doc round-trip drifted")
    # Sparse-vs-dense lowering parity, chunk by chunk (window 3 exercises
    # ragged tails and — on eventless stretches — the shared zero chunk).
    # The checked-window set is bounded by O(events), not O(rounds): on a
    # long pure-agreement stretch every window is the SAME shared zero
    # chunk, so sweeping all of a million-round campaign would cost
    # minutes while proving nothing new.  Small specs check every
    # window; large ones check every event-bearing window plus a spread
    # of empty ones (first/last included) to keep the zero-chunk fast
    # path pinned.
    step = 3
    n_windows = (spec.rounds + step - 1) // step
    if n_windows <= 512:
        windows = range(n_windows)
    else:
        picked = {r // step for r in sparse.event_rounds}
        picked.update((0, n_windows - 1))
        picked.update(range(0, n_windows, n_windows // 8))
        windows = sorted(picked)
    for w in windows if block is not None else ():
        lo = w * step
        hi = min(lo + step, spec.rounds)
        dense_chunk = block.chunk(lo, hi)
        sparse_chunk = sparse.chunk(lo, hi)
        for name, plane in dense_chunk.items():
            if not np.array_equal(plane, sparse_chunk[name]):
                raise ScenarioError(
                    f"sparse lowering diverges from dense at rounds "
                    f"[{lo}, {hi}) plane {name!r}"
                )
    if block is not None:
        mutations = int(
            block.kill.sum()
            + block.revive.sum()
            + (block.set_faulty >= 0).sum()
            + (block.set_strategy >= 0).sum()
        )
        parity = f"{mutations} mutated cell(s), sparse parity clean"
    else:
        # Exercise the sparse chunk path (bounds, event replay, the
        # shared zero chunk) even when the dense reference is skipped.
        for w in windows:
            sparse.chunk(w * step, min(w * step + step, spec.rounds))
        parity = (
            f"dense parity probe skipped ({dense_cells / 1e6:.0f}M cells)"
        )
    sparsity = len(event_rounds(spec)) / spec.rounds
    return (
        f"{path}: OK — {spec.name!r}, {spec.rounds} round(s), "
        f"{len(spec.events)} event(s) at probe capacity {capacity}, "
        f"{parity} ({sparsity:.0%} of rounds carry events)"
    )


def _check_checkpoint(path: str) -> str:
    meta = validate_carry_checkpoint(path)
    kind = "scenario" if meta.get("scenario") else "plain"
    return (
        f"{path}: OK — carry checkpoint v{meta['v']} ({kind}), "
        f"round {meta['round']}"
        + (
            f" of {meta['rounds_total']}"
            if meta.get("rounds_total") is not None
            else ""
        )
    )


def main(argv) -> int:
    if not argv:
        print(
            "usage: python -m ba_tpu_torch.scenario <spec.json|ckpt.npz> ...",
            file=sys.stderr,
        )
        return 2
    for path in argv:
        try:
            if path.endswith(".npz"):
                print(_check_checkpoint(path))
            else:
                print(_check_spec(path))
        except (OSError, ValueError) as e:  # ScenarioError is a ValueError
            print(f"{path}: FAIL — {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
