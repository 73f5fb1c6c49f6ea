"""The cells at a size a CPU test run holds: the same kinds of input
(ragged n, traitors, traitorous commanders, kills, size buckets, spoiled
signatures) at a few dozen instances of a few dozen generals, few rounds,
on the port's plain engine (``engine="torch"``)."""

from __future__ import annotations

from portbench import harness

CONFIG = {
    "om1_b10k_n1024": {"batch": 48, "capacity": 64, "min_n": 16, "max_n": 64},
    "sm3_signed_b10k_n1024": {"batch": 16, "capacity": 256},
}
TRAFFIC = {
    "pipeline_sweep": {"rounds": 8, "rounds_per_dispatch": 4, "max_campaigns": 64,
                       "trace_campaigns": 2, "check": {"retain_every": 2, "campaigns": 2,
                                                       "rounds": 2, "instances": 6}},
    "failover_sweep": {"rounds": 4, "kill_planes": 2, "p_kill": 0.05, "max_campaigns": 64,
                       "trace_campaigns": 4, "check": {"retain_every": 2, "campaigns": 2,
                                                       "instances": 8}},
    "fused_signed_sweep": {"steps": 2, "rounds": 8, "max_campaigns": 64, "trace_campaigns": 2,
                           "check": {"retain_every": 2, "campaigns": 2, "rows": 4,
                                     "table_rows": 2}},
}
WORKLOADS = ("om1_sweep.plain", "sm3_fused.tables", "om1_failover.crash")


def tiny_cell(workload: str) -> dict:
    cell = harness.load_cell(workload)
    cell["config"] = {**cell["config"], **CONFIG[cell["config_name"]]}
    cell["traffic"] = {**cell["traffic"], **TRAFFIC[cell["traffic"]["driver"]]}
    return cell


def run_tiny(workload: str, seed: int, *, seconds: float = 0.3, trace: bool = False) -> dict:
    import time

    return harness.run_cell(tiny_cell(workload), seed, seconds, trace, device="cpu",
                            engine="torch", t_start=time.perf_counter())
