"""k1_plain_roofline (%): the least time of the traced K1 plain-mode
dispatches (the frozen work and byte counts over the card's peaks) over
K1's device time in the trace (``megastep_kernel`` and the counter rows'
``counter_rows_kernel``).  Nothing when the trace's launches are not the
dispatches counted."""

K1 = ("megastep_kernel", "counter_rows_kernel")
KEY = "k1_plain"


def read(run):
    if KEY not in run.bounds:
        return None
    bound_s, _, launches = run.bounds[KEY]
    events = run.trace.kernels(*K1)
    if sum(K1[0] in name for name, _, _ in events) != launches:
        return None
    busy = sum(e - s for _, s, e in events)
    return 100.0 * bound_s / busy if busy > 0 else None
