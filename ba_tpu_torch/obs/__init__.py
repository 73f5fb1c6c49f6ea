"""Observability (counterpart of ``ba_tpu.obs``): run identity, run
scopes and the flight summary (``flight``), the metrics registry
(``registry``), host spans and trace contexts (``trace``), the live
health sampler (``health``), the CUDA graph cache of the serving tier
(``graphcache``), the compile classification, recompile explainer and
cross-run compile ledger (``instrument``), the device tier on the card
(``cuda``: kernel artifact records, NVTX annotations, profiler capture;
it replaces the reference's ``obs.xla``), the SLO engine (``slo``) and the
merge of a sink directory's shards (``fleet``); the last two load on first
use, so that ``python -m ba_tpu_torch.obs.slo`` and ``python -m
ba_tpu_torch.obs.fleet`` run without runpy's warning.

The sink is ``ba_tpu_torch.utils.metrics``.  Nothing here reads the
environment: ``utils.metrics.configure(target)``, ``trace.configure(path)``,
``instrument.configure_compile_ledger(path)`` and ``cuda.configure(
dump_dir=, profile_dir=)`` turn the parts on, and with none of them the
layer writes no file and grows no buffer.  Importing this package
imports no torch.
"""

from ba_tpu_torch.obs import cuda, flight, health, instrument, registry, trace
from ba_tpu_torch.obs.instrument import (
    classify_compile,
    compile_or_dispatch_span,
    configure_compile_ledger,
    first_call,
    reset_first_calls,
)
from ba_tpu_torch.obs.registry import MetricsRegistry, default_registry
from ba_tpu_torch.obs.trace import Tracer, default_tracer, instant, span, timed_span


def __getattr__(name):
    if name in ("slo", "fleet"):
        import importlib

        return importlib.import_module(f"ba_tpu_torch.obs.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["MetricsRegistry", "Tracer", "classify_compile", "compile_or_dispatch_span",
           "configure_compile_ledger", "cuda", "default_registry", "default_tracer",
           "first_call", "fleet", "flight", "health", "instant", "instrument", "registry",
           "reset_first_calls", "slo", "span", "timed_span", "trace"]
