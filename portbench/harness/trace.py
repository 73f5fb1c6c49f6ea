"""The traced stretch: ``torch.profiler`` around a fixed number of
campaigns, and the reduction of its Chrome trace to what the per-layer
readers take.

The stretch is the harness's own ``portbench.stretch`` annotation; device
time is the union of the kernels, copies and fills inside it.  An idle
gap is named by the innermost host operation or annotation running at its
middle, or "python, no op running" where none is.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class Capture:
    """Profile a block; ``path`` is the exported Chrome trace, in a
    temporary directory that :meth:`close` removes."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-trace-")
        self.path = None

    def __enter__(self):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        return self

    def stretch(self, fn):
        """Run ``fn`` as the traced stretch; returns its result."""
        import torch

        with torch.profiler.record_function(STRETCH):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return out

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.path = os.path.join(self._tmp.name, "trace.json")
            self._prof.export_chrome_trace(self.path)
        return False

    def close(self) -> None:
        self._tmp.cleanup()


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


class Reduced:
    """The stretch's device events ``(name, start_s, end_s)`` clipped to
    it, its host events, its length and the device's busy seconds."""

    def __init__(self, device_events, host_events, window):
        self.window = window
        self.device_events = device_events
        self.host_events = host_events
        self.window_s = window[1] - window[0]
        self.gaps = []
        busy, cursor = 0.0, window[0]
        for _, s, e in sorted(device_events, key=lambda ev: ev[1]):
            if s > cursor:
                self.gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if window[1] > cursor:
            self.gaps.append((cursor, window[1]))
        self.busy_s = busy

    def kernels(self, *patterns: str) -> list:
        """The device events whose name holds one of ``patterns``, by start."""
        return sorted((ev for ev in self.device_events if any(p in ev[0] for p in patterns)),
                      key=lambda ev: ev[1])

    def gap_label(self, t: float) -> str:
        inner = None
        for name, s, e in self.host_events:
            if s <= t <= e and (inner is None or e - s < inner[1]):
                inner = (name, e - s)
        return "host: " + (inner[0] if inner else "python, no op running")

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, s, e in self.device_events:
            key = _clean(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[name, s] for name, s in ops],
                "idle_gaps": [[_clean(self.gap_label((a + b) / 2)), b - a] for a, b in gaps]}


def reduce(path: str) -> Reduced:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev]
    stretch = next(ev for ev in spans if ev["name"] == STRETCH and ev.get("cat") in HOST_CATS)
    w0 = stretch["ts"] * 1e-6
    w1 = w0 + stretch["dur"] * 1e-6
    device, host = [], []
    for ev in spans:
        s = ev["ts"] * 1e-6
        e = s + ev["dur"] * 1e-6
        if e <= w0 or s >= w1:
            continue
        if ev.get("cat") in DEVICE_CATS:
            device.append((ev["name"], max(s, w0), min(e, w1)))
        elif ev.get("cat") in HOST_CATS and ev["name"] != STRETCH and ev["tid"] == stretch["tid"]:
            host.append((ev["name"], s, e))
    return Reduced(device, host, (w0, w1))


class TraceRun:
    """What a per-layer reader gets: ``trace`` (a :class:`Reduced`),
    ``spans`` (the harness's host spans by name, seconds), ``bounds``
    (kernel -> (least seconds of the traced launches, what bounds them,
    launches)) and ``counters`` (the program's counters)."""

    def __init__(self, trace: Reduced, spans: dict, bounds: dict, counters: dict):
        self.trace = trace
        self.spans = spans
        self.bounds = bounds
        self.counters = counters
