"""The benchmark's harness: it finds a cell's configuration, traffic mix,
driver and per-layer readers by the names in ``BENCHMARK.json``, runs the
cell once and assembles its result line.

A run: set-up (inputs from the seed on the device, the program's own
set-up, one warm-up campaign a slot in flight), then a closed loop of
campaigns for ``--seconds`` (``--trace 0``) or a fixed number of them
under the profiler (``--trace 1``), then the comparison with the plain
reference.  Campaigns keep ``in_flight`` of them queued: campaign c + 1 is
queued before campaign c's results are fetched.  The window opens when the
first campaign is queued and closes when the last one queued before
``seconds`` had passed has its results on the host; every campaign queued
in it counts.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ba_tpu")


def load_cell(workload: str, benchmark_path: Path | None = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix and the metrics it reports."""
    spec = json.loads((benchmark_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    return {
        "name": workload,
        "config_name": cell["config"],
        "chips": cell["chips"],
        "config": json.loads((ROOT / config["file"]).read_text()),
        "traffic": json.loads((PACKAGE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": spec["end_to_end"],
        "per_layer": per_layer,
    }


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}").Driver


def load_reader(metric: str):
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Loop:
    """Queue campaigns, ``in_flight`` at a time, and time each from its
    queueing to its results on the host."""

    def __init__(self, driver, in_flight: int):
        self.driver = driver
        self.in_flight = in_flight
        self.latencies: list[float] = []
        self.queued = 0

    def run(self, first: int, *, seconds: float | None = None,
            count: int | None = None) -> float:
        """Queue campaigns from index ``first`` until ``seconds`` have
        passed or ``count`` are queued; wait for all.  Returns the window's
        seconds, from the first queueing to the last result."""
        perf = time.perf_counter
        pending: collections.deque = collections.deque()
        c = first
        t0 = perf()
        while (perf() - t0 < seconds) if count is None else (c - first < count):
            tq = perf()
            pending.append((tq, self.driver.queue(c)))
            c += 1
            if len(pending) >= self.in_flight:
                self._retire(pending)
        while pending:
            self._retire(pending)
        self.queued += c - first
        return perf() - t0

    def _retire(self, pending) -> None:
        tq, handle = pending.popleft()
        self.driver.retire(handle)
        self.latencies.append(time.perf_counter() - tq)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *, device, engine: str,
             t_start: float) -> dict:
    """Run ``cell`` once and return ``{"result", "checks", "lines"}``:
    the result line's object, the numbers compared with their limits,
    and the lines printed before the result."""
    import torch

    from portbench.harness import trace as trace_mod
    from portbench.work import peaks

    traffic = cell["traffic"]
    in_flight = traffic["in_flight"]
    driver = load_driver(traffic["driver"])(cell["config"], traffic, seed, device, engine)
    driver.setup()
    loop = Loop(driver, in_flight)
    loop.run(driver.warmup_first, count=in_flight)  # the cell's shapes, once
    loop.latencies.clear()
    loop.queued = 0
    driver.start_window()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    lines, device_info, breakdown = [], {}, None
    if trace:
        count = traffic["trace_campaigns"]
        cap = trace_mod.Capture()
        with cap:
            window_s = cap.stretch(lambda: loop.run(0, count=count))
        try:
            reduced = trace_mod.reduce(cap.path)
        finally:
            cap.close()
        device_info = {"busy_s": reduced.busy_s, "window_s": reduced.window_s}
        breakdown = reduced.breakdown()
        bounds = driver.trace_bounds(count)
        run = trace_mod.TraceRun(reduced, driver.spans, bounds, driver.stats())
        metrics = {}
        for m in cell["per_layer"]:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for kernel, (b_s, bound_by, launches) in bounds.items():
            lines.append({"roofline": kernel, "bound_by": bound_by, "bound_s": b_s,
                          "launches": launches, "peak_int_ops_per_s": peaks.INT_OPS_PER_S,
                          "peak_bytes_per_s": peaks.HBM_BYTES_PER_S})
    else:
        window_s = loop.run(0, seconds=seconds)
    campaigns = loop.queued
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    lines.append({"program_counters": driver.stats(), "campaigns": campaigns,
                  "window_s": window_s, "setup_s": setup_s})

    if not trace:
        rate = campaigns * driver.rounds_per_campaign / window_s
        e2e = {"agreement_rounds_per_s": rate,
               "campaign_p95_ms": percentile(loop.latencies, 95) * 1e3,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
        lines.append({"campaign_ms": {"count": len(loop.latencies),
                                      "median": statistics.median(loop.latencies) * 1e3,
                                      "p95": percentile(loop.latencies, 95) * 1e3,
                                      "max": max(loop.latencies) * 1e3}})

    checks, failed = compare(driver, campaigns)
    if cuda:
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                       "count": 1, "memory_peak_bytes": memory_peak, **device_info}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0, **device_info}
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
              "attempted": campaigns, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "checks": checks, "lines": lines}


def compare(driver, campaigns: int) -> tuple[dict, int]:
    """The comparison with the plain reference, once the window has
    closed: the program's outputs on the sample against the reference's,
    and the program's outputs against each other.  Returns ({name:
    {"value", "limit"}}, campaigns with any difference)."""
    plan = driver.plan(driver.compared(campaigns))
    got = driver.program_sample(plan)
    driver.prepare(plan)
    driver.release()
    want = driver.reference_sample(plan)
    numbers, bad = mismatches(got, want)
    for name, per_campaign in driver.self_checks(plan).items():
        numbers[name] = sum(per_campaign.values())
        bad |= {c for c, v in per_campaign.items() if v}
    return {name: {"value": int(v), "limit": 0} for name, v in numbers.items()}, len(bad)


def mismatches(got: dict, want: dict) -> tuple[dict, set]:
    """``<key>_mismatch``: the entries of each sampled output that differ,
    summed over the campaigns; and the campaigns with any."""
    numbers, bad = {}, set()
    for key in want:
        total = 0
        for c, ref in want[key].items():
            n = int((got[key][c].cpu().to(ref.dtype) != ref.cpu()).sum()) \
                if got[key][c].shape == ref.shape else ref.numel()
            total += n
            if n:
                bad.add(c)
        numbers[f"{key}_mismatch"] = total
    return numbers, bad
