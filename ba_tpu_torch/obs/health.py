"""The live health view (``ba_tpu/obs/health.py``): a lock-free
sampler over the metrics registry.

A sample reads only GIL-atomic attributes (``registry.get``, a
counter's or gauge's ``.value``, ``Histogram.peek``): it never takes the
registry's lock and never waits for the card.  Each sample derives, over
the window since the previous one (or :meth:`HealthSampler.prime`):
``rounds_per_s``, ``depth_occupancy`` (mean dispatches in flight),
``retire_lag_p50_s`` / ``retire_lag_p99_s``, the window's worst dispatch
latency and ``watchdog_margin_s`` against a timeout, and the mesh's
imbalance gauges where an engine writes them.  It writes the
``health_*`` gauges back into the registry and, with ``emit``, one
``health_snapshot`` record.  Its inputs are the pipelined loops'
``pipeline_*`` instruments (``parallel/pipeline.py``).  After each
sample the installed SLO engine (``obs/slo.py``) gets its report tick.
Stdlib only.  The lock-free claim is checked by ba-lint (BA502): the
declaration below puts the module under its single-opcode read
discipline.
"""

# ba-lint: lockfree

from __future__ import annotations

import time

from ba_tpu_torch.obs import registry as _registry
from ba_tpu_torch.utils import metrics as _metrics

HEALTH_GAUGES = (
    "health_rounds_per_s",
    "health_depth_occupancy",
    "health_retire_lag_p50_s",
    "health_retire_lag_p99_s",
    "health_watchdog_margin_s",
    "health_plane_imbalance",
    "health_carry_imbalance",
)


def _counter_value(reg, name: str) -> int:
    inst = reg.get(name)
    return inst.value if inst is not None else 0


def _gauge_value(reg, name: str):
    inst = reg.get(name)
    return inst.value if inst is not None else None


def _hist_peek(reg, name: str):
    inst = reg.get(name)
    return inst.peek() if inst is not None else None


class HealthSampler:
    """Periodic health sampling with per-window deltas.

    One sampler = one observation stream: consecutive :meth:`sample`
    calls difference counters and histogram buckets, so two independent
    consumers (a REPL and an engine loop) should each hold their own.
    ``timeout_s`` is the retire-watchdog timeout the margin is measured
    against (None = no margin reported).
    """

    def __init__(self, registry=None, timeout_s: float | None = None):
        self._registry = registry
        self.timeout_s = timeout_s
        self._last_t: float | None = None
        self._last_rounds = 0
        self._last_retires = 0
        self._last_occ = (0, 0.0)  # (count, sum) of the occupancy hist
        self._last_lag_counts = None
        self._last_lat_counts = None
        self.samples = 0

    def _reg(self):
        return (
            self._registry
            if self._registry is not None
            else _registry.default_registry()
        )

    def prime(self) -> None:
        """Record the current registry state as the window baseline
        WITHOUT producing a sample.  The engine primes its per-sweep
        sampler before the first dispatch, so the first emitted sample
        is a real window of THIS campaign — never a blend of every
        earlier sweep's process-lifetime totals (the registry is
        process-global; a fresh sampler's zero baselines would read the
        lifetime aggregates as one giant first window)."""
        reg = self._reg()
        self._last_t = time.perf_counter()
        self._last_rounds = _counter_value(reg, "pipeline_rounds_total")
        self._last_retires = _counter_value(reg, "pipeline_retires_total")
        occ = _hist_peek(reg, "pipeline_depth_occupancy")
        if occ is not None:
            self._last_occ = (occ["count"], occ["sum"])
        lag = _hist_peek(reg, "pipeline_retire_lag_s")
        if lag is not None:
            self._last_lag_counts = lag["counts"]
        lat = _hist_peek(reg, "pipeline_dispatch_latency_s")
        if lat is not None:
            self._last_lat_counts = lat["counts"]

    def sample(self, emit: bool = False, sink=None, **extra) -> dict:
        """Take one sample: lock-free reads → derived dict → ``health_*``
        gauges (and, with ``emit``, one ``health_snapshot`` record).
        ``extra`` keys ride the record (dispatch index, campaign name).
        """
        reg = self._reg()
        now = time.perf_counter()
        rounds = _counter_value(reg, "pipeline_rounds_total")
        retires = _counter_value(reg, "pipeline_retires_total")
        occ = _hist_peek(reg, "pipeline_depth_occupancy")
        lag_hist = reg.get("pipeline_retire_lag_s")
        lag = lag_hist.peek() if lag_hist is not None else None
        lat = _hist_peek(reg, "pipeline_dispatch_latency_s")

        dt = None if self._last_t is None else now - self._last_t
        rounds_per_s = None
        if dt and dt > 0:
            rounds_per_s = (rounds - self._last_rounds) / dt

        # Every derived metric below is a PER-WINDOW delta between this
        # sample and the previous one (or prime()) — never a
        # process-lifetime aggregate: the registry outlives campaigns,
        # and a lifetime max/mean would alarm on dispatch 0's compile
        # (or a previous sweep) forever.  A sampler with no window yet
        # reports None rather than fake lifetime numbers.
        windowed = dt is not None
        occupancy = None
        if windowed and occ is not None:
            d_count = occ["count"] - self._last_occ[0]
            d_sum = occ["sum"] - self._last_occ[1]
            if d_count > 0:
                occupancy = d_sum / d_count

        p50 = p99 = None
        if (
            windowed
            and lag is not None
            and lag_hist is not None
            and self._last_lag_counts is not None
        ):
            p50 = _registry.delta_quantile(
                lag_hist, self._last_lag_counts, lag["counts"], 0.5
            )
            p99 = _registry.delta_quantile(
                lag_hist, self._last_lag_counts, lag["counts"], 0.99
            )

        # The window's worst dispatch latency, as the upper edge of the
        # highest bucket the window touched (the histogram's .max is
        # lifetime-scoped; buckets are the only windowable signal — the
        # edge over-reads by at most one bucket factor, which errs the
        # margin conservative).
        lat_hist = reg.get("pipeline_dispatch_latency_s")
        lat_max = None
        if (
            windowed
            and lat is not None
            and lat_hist is not None
            and self._last_lat_counts is not None
        ):
            lat_max = _registry.delta_quantile(
                lat_hist, self._last_lat_counts, lat["counts"], 1.0
            )
        margin = None
        if (
            self.timeout_s is not None
            and lat_max is not None
            and lat_max != float("inf")
        ):
            margin = self.timeout_s - lat_max

        shards = _gauge_value(reg, "pipeline_shards")
        plane_shard = _gauge_value(reg, "scenario_plane_bytes_per_shard")
        carry_shard = _gauge_value(reg, "pipeline_carry_bytes_per_shard")
        # Both imbalances are MEASURED by the engine (max device share /
        # mean, from addressable-shard metadata at stage/stage-in time —
        # parallel/pipeline.py), never derived here from totals: a
        # total/shards identity could only ever read 1.0.
        carry_imb = _gauge_value(reg, "pipeline_carry_imbalance")
        plane_imb = _gauge_value(reg, "scenario_plane_imbalance")

        snap = {
            "interval_s": round(dt, 6) if dt is not None else None,
            "rounds_per_s": (
                round(rounds_per_s, 3) if rounds_per_s is not None else None
            ),
            "rounds_total": rounds,
            "retires_total": retires,
            "depth_occupancy": (
                round(occupancy, 3) if occupancy is not None else None
            ),
            "retire_lag_p50_s": p50,
            "retire_lag_p99_s": p99,
            "dispatch_latency_max_s": lat_max,
            "watchdog_timeout_s": self.timeout_s,
            "watchdog_margin_s": (
                round(margin, 6) if margin is not None else None
            ),
            "shards": int(shards) if shards else None,
            "plane_bytes_per_shard": plane_shard,
            "carry_bytes_per_shard": carry_shard,
            "plane_imbalance": (
                round(plane_imb, 4) if plane_imb is not None else None
            ),
            "carry_imbalance": carry_imb,
            "stalls_total": _counter_value(reg, "pipeline_stalls_total"),
        }

        for gauge, key in (
            ("health_rounds_per_s", "rounds_per_s"),
            ("health_depth_occupancy", "depth_occupancy"),
            ("health_retire_lag_p50_s", "retire_lag_p50_s"),
            ("health_retire_lag_p99_s", "retire_lag_p99_s"),
            ("health_watchdog_margin_s", "watchdog_margin_s"),
            ("health_plane_imbalance", "plane_imbalance"),
            ("health_carry_imbalance", "carry_imbalance"),
        ):
            v = snap[key]
            if v is not None and v != float("inf"):
                reg.gauge(gauge).set(v)

        self._last_t = now
        self._last_rounds = rounds
        self._last_retires = retires
        if occ is not None:
            self._last_occ = (occ["count"], occ["sum"])
        if lag is not None:
            self._last_lag_counts = lag["counts"]
        if lat is not None:
            self._last_lat_counts = lat["counts"]
        self.samples += 1  # ba-lint: disable=BA502 (only the sampler's own thread writes it)

        if emit:
            record = {
                "event": "health_snapshot",
                "v": _metrics.SCHEMA_VERSION,
                **extra,
                **{
                    k: (None if v == float("inf") else v)
                    for k, v in snap.items()
                },
            }
            (sink or _metrics.default_sink()).emit(record)

        # An installed SLO engine reports on this sampler's cadence (its
        # own report_every_s decides whether a report is due).  A failure
        # of that bookkeeping is counted and never stops the sweep that
        # is sampling.
        from ba_tpu_torch.obs import slo as _slo

        eng = _slo.installed()
        if eng is not None:
            try:
                eng.maybe_report(sink=sink)
            except Exception:
                reg.counter("slo_report_errors_total").inc()
        return snap


_default: HealthSampler | None = None


def default_sampler() -> HealthSampler:
    """Process-wide sampler (the REPL's ``stats --live`` stream: rates
    are measured since the previous call on THIS sampler)."""
    global _default
    if _default is None:
        _default = HealthSampler()
    return _default
