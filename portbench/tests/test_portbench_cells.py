"""Each cell end to end at a tiny size on the CPU (the port's plain engine):
the run against the reference comes out correct, and with the timed path
broken underneath it comes out not correct, once for each fault the cell
can have."""

from __future__ import annotations

import pytest
import torch

from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.ops import sweep_step
from ba_tpu_torch.parallel import pipeline
from portbench.tests.tiny import WORKLOADS, run_tiny

SEED = 2**31 + 1234567


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct(workload, trace):
    out = run_tiny(workload, SEED, trace=trace)
    result = out["result"]
    assert result["correct"], out["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["limit"] == 0 and c["value"] == 0 for c in out["checks"].values())
    if not trace:
        assert set(result["metrics"]) == {"agreement_rounds_per_s", "campaign_p95_ms",
                                          "setup_s"}
        assert result["metrics"]["agreement_rounds_per_s"]["value"] > 0


def _zero_second_half(t: torch.Tensor, axis: int) -> None:
    half = t.shape[axis] // 2
    t.narrow(axis, half, t.shape[axis] - half).zero_()


def _alter_every_fourth(t: torch.Tensor, axis: int) -> None:
    idx = torch.arange(0, t.shape[axis], 4)
    t.index_copy_(axis, idx, (t.index_select(axis, idx) + 1) % 3)


def _plain(fault):
    orig = pipeline.pipeline_megastep

    def broken(state, sched, **kw):
        counter = sched.counter.clone()
        out = orig(state, sched, **kw)
        if fault == "state_unchanged":  # the key schedule does not advance
            sched.counter.copy_(counter)
        elif fault == "half_batch":
            _zero_second_half(out[3], 1)
        else:
            _alter_every_fourth(out[3], 1)
        return out

    return pipeline, "pipeline_megastep", broken


def _failover(fault):
    orig = pipeline.scenario_megastep

    def broken(state, sched, strategy, counters, events, **kw):
        if fault == "state_unchanged":  # the kills are not applied
            events = dict(events, kill=torch.zeros_like(events["kill"]))
        out = orig(state, sched, strategy, counters, events, **kw)
        if fault == "half_batch":
            _zero_second_half(out[4], 1)
            _zero_second_half(out[6], 1)
        elif fault == "answer_altered":
            _alter_every_fourth(out[6], 1)
        return out

    return pipeline, "scenario_megastep", broken


def _signed(fault):
    orig = sweep_step.fused_signed_sweep_step

    def broken(*args, **kw):
        dec = orig(*args, **kw).clone()
        if fault == "half_batch":
            _zero_second_half(dec, 0)
        else:
            _alter_every_fourth(dec, 0)
        return dec

    return sweep_step, "fused_signed_sweep_step", broken


FAULTS = [("om1_sweep.plain", _plain, "state_unchanged"),
          ("om1_sweep.plain", _plain, "half_batch"),
          ("om1_sweep.plain", _plain, "answer_altered"),
          ("om1_failover.crash", _failover, "state_unchanged"),
          ("om1_failover.crash", _failover, "half_batch"),
          ("om1_failover.crash", _failover, "answer_altered"),
          ("sm3_fused.tables", _signed, "half_batch"),
          ("sm3_fused.tables", _signed, "answer_altered")]


@pytest.mark.parametrize("workload,make,fault", FAULTS,
                         ids=[f"{w}-{f}" for w, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, make, fault):
    module, name, broken = make(fault)
    monkeypatch.setattr(module, name, broken)
    out = run_tiny(workload, SEED)
    assert not out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] >= 1


def test_state_copy_is_what_the_entry_consumes():
    """pipeline_sweep consumes its state; each campaign gets its own copy,
    so the set-up state is never touched."""
    from portbench.drivers.pipeline_sweep import Driver
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("om1_sweep.plain")
    driver = Driver(cell["config"], cell["traffic"], SEED, "cpu", "torch")
    driver.setup()
    before = {k: v.clone() for k, v in driver.state.items()}
    driver.queue(0)
    assert all(torch.equal(before[k], driver.state[k]) for k in before)
    assert isinstance(SimState(**driver.state), SimState)
