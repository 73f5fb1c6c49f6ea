"""Observability (counterpart of ``ba_tpu.obs``): run identity, run
scopes and the flight summary (``flight``), the metrics registry
(``registry``), host spans and trace contexts (``trace``), the live
health sampler (``health``) and the CUDA graph cache of the serving tier
(``graphcache``).

The sink is ``ba_tpu_torch.utils.metrics``.  Nothing here reads the
environment: ``utils.metrics.configure(target)`` and
``trace.configure(path)`` turn the sink and the tracer on, and with
neither the layer writes no file and grows no buffer.  Importing this
package imports no torch.
"""

from ba_tpu_torch.obs import flight, health, registry, trace
from ba_tpu_torch.obs.registry import MetricsRegistry, default_registry
from ba_tpu_torch.obs.trace import Tracer, default_tracer, instant, span, timed_span

__all__ = ["MetricsRegistry", "Tracer", "default_registry", "default_tracer", "flight",
           "health", "instant", "registry", "span", "timed_span", "trace"]
