"""ba-lint for the port: the AST analyzer of ``ba_tpu_torch``'s contracts
(``ba_tpu/analysis/``, each rule read for torch and CUDA).

The port keeps the reference's contracts: no host sync inside the
dispatch loops but the depth-delayed retire, keys derived on the device
from the ``KeySchedule`` counter, a megastep's carry never read after the
megastep updated it in place, a host-tier observability layer that the
device trees never reach, no environment reads.  This package checks
them over real ``ast`` trees and the real import graph, alias-resolved.

It imports the standard library only: no torch, no numpy, no jax and
nothing of ``ba_tpu`` (``ba_tpu_torch/__init__.py`` imports nothing), so
it runs on the card's machine, which has no jax, and on any host.  It
keeps its own copy of every layer it needs.

Usage::

    python -m ba_tpu_torch.analysis ba_tpu_torch chip_smoke.py tests/test_torch_*.py
    python -m ba_tpu_torch.analysis --format json --rules BA101,BA301 path/

Rules (each rule module's docstring gives its torch meaning and marks
every departure from the reference):

====== ============================== ====================================
code   name                           invariant
====== ============================== ====================================
BA101  host-sync-in-hot-path          no ``torch.cuda.synchronize`` or
                                      ``.synchronize()`` in the hot trees;
                                      no ``.item()`` / ``.tolist()`` /
                                      ``.cpu()`` / ``.numpy()`` / blocking
                                      ``.to("cpu")`` / ``float()`` /
                                      ``int()`` / ``bool()`` of torch values
                                      in the dispatch-loop modules
BA102  host-key-split-in-pipeline     no ``rng.split`` (and no
                                      ``rng.fold_in`` in a host loop) in
                                      ``parallel/pipeline.py``
BA201  use-after-donate               a carry handed to a megastep that
                                      updates it in place is not read
                                      again before rebinding
BA202  rng-key-reuse                  one key name is not drawn from twice
                                      (``core/rng.py``'s draws) before
                                      rebinding
BA301  obs-purity                     ``core`` / ``ops`` never reach
                                      ``obs`` or ``metrics.emit``; ``obs``
                                      and the host-tier modules never reach
                                      ``core`` / ``ops`` at import
BA401  dead-import                    unused imports (warning)
BA501  unsynchronized-shared-mutation one lock over every cross-thread write
BA502  lockfree-read-discipline       ``# ba-lint: lockfree`` modules read
                                      shared state in single opcodes
BA503  lock-order-cycle               the acquired-while-held graph is
                                      acyclic
BA504  leaked-timer-daemon-lifecycle  timers cancelled, non-daemon threads
                                      joined
BA601  record-schema                  emit sites match the port's record
                                      families
BA602  metric-naming                  ``serve_`` prefix, ``_per_shard``
                                      suffix
BA603  env-read                       the port reads no environment
====== ============================== ====================================

Suppressions: append ``# ba-lint: disable=BA101`` (comma-separated
codes, or ``all``) to the flagged line, or put
``# ba-lint: disable-file=BAxxx`` on its own line to silence a code for
the whole file.  Suppressed findings are counted but never fail the run.
"""

from ba_tpu_torch.analysis.base import Finding, Rule, all_rules
from ba_tpu_torch.analysis.driver import main, run_paths

__all__ = ["Finding", "Rule", "all_rules", "main", "run_paths"]
