"""Cross-module BA201 and parallel-wide BA101 fixture (never run).

``megastep`` updates its carry in ``pipeline.py``; the call sites here
resolve through an import alias.  ``pipeline_sweep`` is BA201's known
consumer by qualified name.  A sync is banned across all of
``ba_tpu_torch.parallel``, the drains only in the dispatch-loop modules.
"""

from ba_tpu_torch.parallel.pipeline import megastep as step
from ba_tpu_torch.parallel.pipeline import pipeline_sweep


def positive_cross_module(state, sched):
    out = step(state, sched)
    return state, out  # expect: BA201


def positive_known_consumer(key, state):
    out = pipeline_sweep(key, state, 64)
    return out, state.alive  # expect: BA201


def positive_sync_outside_the_loop_modules(stream):
    stream.synchronize()  # expect: BA101


def negative_drain_outside_the_loop_modules(x):
    return x.item(), x.cpu()


def negative_key_survives(key, state):
    state2 = pipeline_sweep(key, state, 64)["final_state"]
    return pipeline_sweep(key, state2, 1)
