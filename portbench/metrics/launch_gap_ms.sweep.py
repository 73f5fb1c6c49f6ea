"""launch_gap_ms.sweep (ms): the mean device gap between consecutive K1
launches (``megastep_kernel``) over the traced stretch: from the end of one
to the start of the next, whatever runs between them."""

K1 = "megastep_kernel"


def read(run):
    launches = run.trace.kernels(K1)
    if len(launches) < 2:
        return None
    gaps = [max(0.0, b[1] - a[2]) for a, b in zip(launches, launches[1:])]
    return 1e3 * sum(gaps) / len(gaps)
