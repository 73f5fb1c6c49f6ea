"""BA301 fixture: a host-layer module may instrument itself (the
boundary case): ``core.pure`` imports it without contamination."""

from ba_tpu_torch.obs import default_registry


def clamp(x):
    default_registry().counter("clamp_calls_total").inc()
    return x
