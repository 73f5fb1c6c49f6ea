"""k2_roofline (%): the least time of the traced K2 dispatches (the frozen
Philox, relay and choice counts over the card's peaks) over K2's device
time in the trace (``sweep_step_kernel``).  Nothing when the trace's
launches are not the dispatches counted."""

K2 = "sweep_step_kernel"
KEY = "k2"


def read(run):
    if KEY not in run.bounds:
        return None
    bound_s, _, launches = run.bounds[KEY]
    events = run.trace.kernels(K2)
    if len(events) != launches:
        return None
    busy = sum(e - s for _, s, e in events)
    return 100.0 * bound_s / busy if busy > 0 else None
