"""wrapper_host_ms.failover (ms): the mean host time of a failover_sweep
call in the traced stretch, from its call to its return (the wrapper's
work before and around the K1 launch; the launch itself is queued)."""


def read(run):
    calls = run.spans.get("failover_sweep", [])
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
