"""k1_scenario_roofline (%): as k1_plain_roofline, for the traced K1
scenario-mode launches (the failover campaigns, event planes counted)."""

K1 = ("megastep_kernel", "counter_rows_kernel")
KEY = "k1_scenario"


def read(run):
    if KEY not in run.bounds:
        return None
    bound_s, _, launches = run.bounds[KEY]
    events = run.trace.kernels(*K1)
    if sum(K1[0] in name for name, _, _ in events) != launches:
        return None
    busy = sum(e - s for _, s, e in events)
    return 100.0 * bound_s / busy if busy > 0 else None
