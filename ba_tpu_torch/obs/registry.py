"""The metrics registry (``ba_tpu/obs/registry.py``): typed counters,
gauges and log-bucketed histograms that aggregate in memory.

Updating an instrument costs a lock and a few scalar operations and
writes nothing; a registry dumps two ways: :meth:`MetricsRegistry.emit_snapshot`
(one ``metrics_snapshot`` record into the JSON-lines sink, a no-op
write when the sink is off) and :meth:`MetricsRegistry.prometheus_text`.

Histograms are log-bucketed: bucket ``i`` counts values in
``(base * factor**(i-1), base * factor**i]`` (values <= base in bucket 0,
values past the last edge in the ``+Inf`` overflow bucket); the default
(base 1 us, factor 2, 40 buckets) spans microseconds to minutes, and
occupancy histograms pass ``base=1.0``.  Names follow the JAX package's
two rules: a per-device share ends in ``_per_shard``, and a serving
metric starts with ``serve_``.  Stdlib only.
"""

from __future__ import annotations

import bisect
import threading

from ba_tpu_torch.utils import metrics as _metrics


class Counter:
    """Monotonic counter (events, dispatches, retires, signs...)."""

    kind = "counter"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (cache enabled, live depth...)."""

    kind = "gauge"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Log-bucketed distribution (latencies, occupancy, compile time)."""

    kind = "histogram"

    def __init__(
        self,
        lock: threading.Lock,
        base: float = 1e-6,
        factor: float = 2.0,
        n_buckets: int = 40,
    ):
        if base <= 0 or factor <= 1 or n_buckets < 1:
            raise ValueError(
                f"bad histogram shape: base={base} factor={factor} "
                f"n_buckets={n_buckets}"
            )
        self._lock = lock
        self.base = base
        self.factor = factor
        # _counts[i] for i < n_buckets covers (edge(i-1), edge(i)];
        # _counts[n_buckets] is the +Inf overflow bucket.
        self._counts = [0] * (n_buckets + 1)
        # the upper edges, multiplied out as edge(i) walks them
        edges = [base]
        for _ in range(1, n_buckets):
            edges.append(edges[-1] * factor)
        self._edges = edges
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def _index(self, v: float) -> int:
        """The first bucket whose upper edge is >= v (NaN overflows)."""
        if v != v:
            return len(self._edges)
        return bisect.bisect_left(self._edges, v)

    def record(self, v: float) -> None:
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def record_many(self, values) -> None:
        """:meth:`record` of each value in turn, under one lock."""
        if not values:
            return
        edges, nan = self._edges, len(self._edges)
        idx = [nan if v != v else bisect.bisect_left(edges, v) for v in values]
        with self._lock:
            for i, v in zip(idx, values):
                self._counts[i] += 1
                self.sum += v
            self.count += len(idx)
            lo, hi = min(values), max(values)
            self.min = lo if self.min is None else min(self.min, lo)
            self.max = hi if self.max is None else max(self.max, hi)

    def edge(self, i: int) -> float:
        """Upper boundary of bucket ``i`` (inclusive)."""
        return self.base * self.factor**i

    def peek(self) -> dict:
        """A lock-free read of the histogram's state (the health
        sampler's): every field is a GIL-atomic attribute read and the
        bucket list copies element-by-element under the GIL, so a
        concurrent ``record`` can at worst make the copy off by the
        in-flight sample — monitoring-grade consistency without ever
        contending with the engine's hot-loop updates."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "counts": list(self._counts),
        }

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {
                "type": "histogram",
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
            }
        # Sparse [upper_edge, count] pairs, non-empty buckets only — a
        # 40-bucket histogram with 3 occupied buckets snapshots 3 pairs.
        # The overflow edge is the STRING "+Inf", not float('inf'):
        # json.dumps would serialize the float as the bare token
        # `Infinity`, which Python's json accepts but strict consumers
        # (jq, JSON.parse, Go) reject — breaking the every-record-parses
        # schema contract.
        out["buckets"] = [
            ["+Inf" if i == len(counts) - 1 else self.edge(i), c]
            for i, c in enumerate(counts)
            if c
        ]
        return out


def delta_quantile(hist: Histogram, counts_then, counts_now, q: float):
    """Approximate quantile of the samples recorded BETWEEN two
    ``Histogram.peek`` calls: the upper edge of the bucket where the
    delta-cumulative count crosses ``q`` (``inf`` for the overflow
    bucket; ``None`` for an empty window).

    The health sampler (``obs/health.py``) differences lock-free
    ``peek()`` snapshots through this one helper.  ``counts_then`` may be ``None`` (no baseline yet — the
    whole histogram is the window).
    """
    if counts_then is None:
        counts_then = [0] * len(counts_now)
    deltas = [
        max(0, now - then) for now, then in zip(counts_now, counts_then)
    ]
    total = sum(deltas)
    if not total:
        return None
    need = q * total
    cum = 0
    for i, c in enumerate(deltas):
        cum += c
        if cum >= need:
            if i == len(deltas) - 1:
                return float("inf")
            return hist.edge(i)
    return None


class MetricsRegistry:
    """Thread-safe name → instrument map with snapshot/exposition dumps."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, name: str, factory):
        # A per-device share ends in `_per_shard`; a serving metric
        # starts with `serve_` (token-wise: `equivocation_observed` holds
        # "serve" only as letters), so one prefix match scrapes a family.
        if "per_shard" in name and not name.endswith("_per_shard"):
            raise ValueError(f"metric name {name!r} mentions per_shard but does not "
                             f"end with '_per_shard'")
        if "serve" in name.split("_") and not name.startswith("serve_"):
            raise ValueError(f"metric name {name!r} mentions the serve token but "
                             f"does not start with 'serve_'")
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
        return inst

    def get(self, name: str):
        """The existing instrument named ``name``, or None — WITHOUT
        creating one and WITHOUT taking the registry lock (a dict read
        is atomic under the GIL).  The health sampler's lock-free read
        path: sampling must never contend with the engine's hot-loop
        updates."""
        return self._instruments.get(name)

    def counter(self, name: str) -> Counter:
        inst = self._get(name, lambda: Counter(self._lock))
        if not isinstance(inst, Counter):
            raise TypeError(f"{name!r} is a {inst.kind}, not a counter")
        return inst

    def gauge(self, name: str) -> Gauge:
        inst = self._get(name, lambda: Gauge(self._lock))
        if not isinstance(inst, Gauge):
            raise TypeError(f"{name!r} is a {inst.kind}, not a gauge")
        return inst

    def histogram(self, name: str, **shape) -> Histogram:
        # Shape kwargs (base/factor/n_buckets) apply on first creation
        # only; later lookups return the existing instrument unchanged.
        inst = self._get(name, lambda: Histogram(self._lock, **shape))
        if not isinstance(inst, Histogram):
            raise TypeError(f"{name!r} is a {inst.kind}, not a histogram")
        return inst

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def emit_snapshot(self, sink=None, **extra) -> dict:
        """One versioned ``metrics_snapshot`` record into the JSONL sink.

        A no-op write when the sink is disabled (the snapshot dict is
        still built and returned, so callers can inspect it either way).
        ``extra`` keys ride on the record (platform, config name...).
        """
        record = {"event": "metrics_snapshot", "v": _metrics.SCHEMA_VERSION,
                  **extra, "metrics": self.snapshot()}
        (sink or _metrics.default_sink()).emit(record)
        return record

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every instrument.

        Histogram buckets are cumulative with an ``+Inf`` terminator, as
        the format requires.  Only occupied edges are emitted (sparse):
        cumulative counts stay correct at every listed edge, so the
        output is valid exposition text, just without zero-delta lines.
        """
        lines = []
        for name, inst in sorted(self.snapshot().items()):
            pname = "".join(
                c if c.isalnum() or c in "_:" else "_" for c in name
            )
            lines.append(f"# TYPE {pname} {inst['type']}")
            if inst["type"] in ("counter", "gauge"):
                lines.append(f"{pname} {inst['value']}")
                continue
            cum = 0
            for le, c in inst["buckets"]:
                cum += c
                le_s = le if le == "+Inf" else format(le, ".6g")
                lines.append(f'{pname}_bucket{{le="{le_s}"}} {cum}')
            if not inst["buckets"] or inst["buckets"][-1][0] != "+Inf":
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {inst['sum']}")
            lines.append(f"{pname}_count {inst['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


_default: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """Process-wide registry (lazily created; tests swap ``_default``)."""
    global _default
    if _default is None:
        _default = MetricsRegistry()
    return _default
