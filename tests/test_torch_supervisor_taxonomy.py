"""The port's fault taxonomy (``ba_tpu_torch/runtime/supervisor.py``) and
fault plans (``runtime/chaos.py``) against the JAX package's, on the CPU:
``classify_fault`` on injected, out-of-memory and transient errors,
``fault_attribution``, ``backoff_s`` equal to the reference's for 50
(seed, token, attempt) triples, ``derive_timeout_s``, the committed plans
in ``examples/faults/`` loading to equal ``to_dict`` output in both
packages, the injector firing before the wrapped call, and the plan
checker's exit codes."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ba_tpu.runtime import chaos as j_chaos
from ba_tpu.runtime import supervisor as j_sup
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.runtime import chaos, supervisor

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANS = sorted((ROOT / "examples" / "faults").glob("*.json"))


def _errors(mod):
    return [mod.InjectedTransient("x"), mod.InjectedFatal("x"),
            mod.InjectedOOM("x (plan 'p', RESOURCE_EXHAUSTED: Out of memory)"),
            RuntimeError("UNAVAILABLE: socket"), RuntimeError("Connection reset by peer"),
            RuntimeError("out of memory while allocating"), ValueError("shape mismatch"),
            KeyError("k")]


def test_classify_fault_matches_reference():
    for got, want in zip(_errors(chaos), _errors(j_chaos)):
        assert supervisor.classify_fault(got) == j_sup.classify_fault(want)
        assert supervisor.fault_attribution(got) == j_sup.fault_attribution(want)
    assert [supervisor.classify_fault(e) for e in _errors(chaos)] == [
        "transient", "fatal", "oom", "transient", "transient", "oom", "fatal", "fatal"]


def test_classify_fault_cuda_oom():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert supervisor.classify_fault(oom) == supervisor.OOM
    assert supervisor.classify_fault(RuntimeError("CUDA out of memory.")) == supervisor.OOM
    assert supervisor.fault_attribution(oom)["error"].startswith("OutOfMemoryError: ")
    marked = RuntimeError("UNAVAILABLE")
    marked.ba_tpu_fault = "fatal"  # the marker wins over the message
    assert supervisor.classify_fault(marked) == supervisor.FATAL


def test_backoff_equals_reference():
    rs = np.random.default_rng(5)
    for _ in range(50):
        seed, attempt = int(rs.integers(0, 2**31)), int(rs.integers(1, 12))
        token = f"serve:{('dispatch', 'retire')[int(rs.integers(0, 2))]}:{int(rs.integers(0, 99))}"
        cfg = supervisor.SupervisorConfig(seed=seed)
        assert supervisor.backoff_s(cfg, attempt, token) == j_sup.backoff_s(
            j_sup.SupervisorConfig(seed=seed), attempt, token)
    with pytest.raises(ValueError):
        supervisor.backoff_s(supervisor.SupervisorConfig(), 0, "t")


def test_supervisor_config_and_timeout():
    cfg = supervisor.SupervisorConfig()
    ref = j_sup.SupervisorConfig()
    assert cfg.max_retries == ref.resolved_max_retries() == 3
    for name in ("backoff_base_s", "backoff_factor", "backoff_max_s", "jitter_frac",
                 "timeout_multiplier", "timeout_floor_s", "timeout_s", "seed"):
        assert getattr(cfg, name) == getattr(ref, name), name
    with pytest.raises(ValueError):
        supervisor.SupervisorConfig(max_retries=-1)
    reg = MetricsRegistry()
    assert supervisor.derive_timeout_s(cfg, reg) == 30.0
    reg.histogram("pipeline_dispatch_latency_s").record(4.0)
    assert supervisor.derive_timeout_s(cfg, reg) == 64.0
    assert supervisor.derive_timeout_s(supervisor.SupervisorConfig(timeout_s=2.5), reg) == 2.5


@pytest.mark.parametrize("path", PLANS, ids=[p.name for p in PLANS])
def test_committed_plans_load_equal_in_both_packages(path):
    plan = chaos.load(str(path))
    assert chaos.to_dict(plan) == j_chaos.to_dict(j_chaos.load(str(path)))
    assert chaos.to_dict(chaos.from_dict(chaos.to_dict(plan))) == chaos.to_dict(plan)


def test_plan_save_and_corrupt(tmp_path):
    plan = chaos.from_dict({"name": "p", "faults": [{"round": 3, "kind": "corrupt",
                                                      "mode": "truncate"}]})
    chaos.save(str(tmp_path / "p.json"), plan)
    assert chaos.load(str(tmp_path / "p.json")) == plan
    for mode in ("flip", "truncate"):
        blob = tmp_path / f"{mode}.bin"
        blob.write_bytes(bytes(range(256)))
        ref = tmp_path / f"{mode}.ref"
        ref.write_bytes(bytes(range(256)))
        chaos.corrupt_file(str(blob), mode)
        j_chaos.corrupt_file(str(ref), mode)
        assert blob.read_bytes() == ref.read_bytes() != bytes(range(256))
    inj = chaos.ChaosInjector(plan)  # the checkpoint hook: corrupt once the round is reached
    target = tmp_path / "ck.bin"
    target.write_bytes(bytes(range(256)))
    inj.after_checkpoint(2, str(target))
    assert target.read_bytes() == bytes(range(256)) and inj.fired == []
    inj.after_checkpoint(4, str(target))
    inj.after_checkpoint(6, str(target))
    assert len(target.read_bytes()) == 128 and [f["round"] for f in inj.fired] == [3]


def test_injector_fires_before_the_call():
    plan = chaos.from_dict({"name": "mix", "faults": [
        {"round": 1, "kind": "transient", "times": 2},
        {"round": 4, "kind": "oom", "phase": "retire"},
        {"round": 6, "kind": "stall", "seconds": 0.01}]})
    inj = chaos.ChaosInjector(plan)
    calls = []

    def call():
        calls.append(1)
        return "ok"

    for _ in range(2):
        with pytest.raises(chaos.InjectedTransient):
            inj.fire(call, "dispatch", 0, 2)
    assert calls == [] and inj.fire(call, "dispatch", 0, 2) == "ok"
    with pytest.raises(chaos.InjectedOOM) as exc:
        inj.fire(call, "retire", 4, 6)
    assert supervisor.classify_fault(exc.value) == "oom"
    assert inj.fire(call, "dispatch", 4, 8) == "ok" and len(calls) == 2
    assert [f["kind"] for f in inj.fired] == ["transient", "transient", "oom", "stall"]


def test_plan_checker_cli(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"name": "x", "faults": [{"round": 0, "kind": "nope"}]}')
    run = [sys.executable, "-m", "ba_tpu_torch.runtime.chaos"]
    ok = subprocess.run(run + [str(p) for p in PLANS], capture_output=True, text=True,
                        cwd=ROOT, timeout=120)
    assert ok.returncode == 0 and ok.stdout.count(": OK") == len(PLANS)
    assert subprocess.run(run + [str(bad)], capture_output=True, cwd=ROOT,
                          timeout=120).returncode == 1
    assert subprocess.run(run, capture_output=True, cwd=ROOT, timeout=120).returncode == 2
