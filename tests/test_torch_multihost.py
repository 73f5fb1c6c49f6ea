"""Several processes: two gloo ranks of 4 CPU entries each form the global
(4, 2) mesh (``tests/torch_multihost_worker.py``) and run
``sharded_sweep``, ``pipeline_sweep(mesh=)`` and ``sm_node_sharded``; the
results equal the port's one-process 8-entry (4, 2) mesh and the
reference's on its 8-device mesh of the same shape (the counterpart of
``tests/test_multihost.py``).  Free ports, a 240 s timeout; tolerance
zero."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

WORKER = pathlib.Path(__file__).parent / "torch_multihost_worker.py"
B_SWEEP, N_SWEEP, B_NODE, N_NODE, R = 32, 16, 16, 8, 6


def _inputs():
    rs = np.random.default_rng(42)
    sweep = dict(order=np.ones(B_SWEEP, np.int8), leader=rs.integers(0, 4, B_SWEEP),
                 faulty=rs.random((B_SWEEP, N_SWEEP)) < 0.3,
                 alive=rs.random((B_SWEEP, N_SWEEP)) < 0.9,
                 ids=np.tile(np.arange(1, N_SWEEP + 1), (B_SWEEP, 1)))
    faulty = np.zeros((B_NODE, N_NODE), bool)
    faulty[:, 3] = True
    node = dict(order=np.ones(B_NODE, np.int8), leader=np.zeros(B_NODE),
                faulty=faulty, alive=np.ones((B_NODE, N_NODE), bool),
                ids=np.tile(np.arange(1, N_NODE + 1), (B_NODE, 1)))
    return sweep, node


def _state(arrays):
    from ba_tpu_torch import convert

    typed = {k: np.asarray(v).astype(t) for (k, v), t in zip(
        arrays.items(), (np.int8, np.int32, bool, bool, np.int32))}
    return convert.state_from_numpy(type("S", (), typed), "cpu")


def run_cases(mesh) -> dict:
    """The port's results on ``mesh`` (one process or several), as lists;
    the worker runs it on the two-process mesh."""
    from ba_tpu_torch.core import rng
    from ba_tpu_torch.parallel import sharded_sweep, sm_node_sharded
    from ba_tpu_torch.parallel.pipeline import pipeline_sweep

    sweep, node = _inputs()
    out_sw = sharded_sweep(mesh, rng.key(9, "cpu"), _state(sweep))
    out_pl = pipeline_sweep(rng.key(21, "cpu"), _state(sweep), R, rounds_per_dispatch=4,
                            collect_decisions=True, with_counters=True, mesh=mesh)
    received = torch.full((B_NODE, N_NODE), 1, dtype=torch.int8)
    out_sm = sm_node_sharded(mesh, rng.key(7, "cpu"), _state(node), 2, received=received)
    out_sm2 = sm_node_sharded(mesh, rng.key(10, "cpu"), _state(node), 2, collapsed=False)
    return {
        "sweep_decision": np.asarray(out_sw["decision"]).tolist(),
        "sweep_histogram": np.asarray(out_sw["histogram"]).tolist(),
        "pipeline_decisions": out_pl["decisions"].tolist(),
        "pipeline_histograms": out_pl["histograms"].tolist(),
        "pipeline_counters": out_pl["counters_per_round"].tolist(),
        "sm_majorities": np.asarray(out_sm["majorities"]).tolist(),
        "sm_decision": np.asarray(out_sm["decision"]).tolist(),
        "sm_exact_decision": np.asarray(out_sm2["decision"]).tolist(),
    }


def _reference_cases() -> dict:
    import jax.numpy as jnp
    import jax.random as jr

    from ba_tpu.core.state import SimState
    from ba_tpu.parallel import make_mesh, sharded_sweep, sm_node_sharded
    from ba_tpu.parallel.pipeline import pipeline_sweep

    mesh = make_mesh((4, 2), ("data", "node"))
    sweep, node = _inputs()

    def state(arrays):
        types = (jnp.int8, jnp.int32, bool, bool, jnp.int32)
        return SimState(**{k: jnp.asarray(np.asarray(v), t)
                           for (k, v), t in zip(arrays.items(), types)})

    out_sw = sharded_sweep(mesh, jr.key(9), state(sweep))
    out_pl = pipeline_sweep(jr.key(21), state(sweep), R, rounds_per_dispatch=4,
                            collect_decisions=True, with_counters=True, mesh=mesh,
                            engine="xla")
    received = jnp.full((B_NODE, N_NODE), 1, jnp.int8)
    out_sm = sm_node_sharded(mesh, jr.key(7), state(node), 2, received=received)
    out_sm2 = sm_node_sharded(mesh, jr.key(10), state(node), 2, collapsed=False)
    return {
        "sweep_decision": np.asarray(out_sw["decision"]).tolist(),
        "sweep_histogram": np.asarray(out_sw["histogram"]).tolist(),
        "pipeline_decisions": np.asarray(out_pl["decisions"]).tolist(),
        "pipeline_histograms": np.asarray(out_pl["histograms"]).tolist(),
        "pipeline_counters": np.asarray(out_pl["counters_per_round"]).tolist(),
        "sm_majorities": np.asarray(out_sm["majorities"]).tolist(),
        "sm_decision": np.asarray(out_sm["decision"]).tolist(),
        "sm_exact_decision": np.asarray(out_sm2["decision"]).tolist(),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multihost") / "out.json"
    port = _free_port()
    env = dict(os.environ)
    repo_root = str(WORKER.parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(i), "2", str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=repo_root)
             for i in range(2)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out (the gloo join hung?)")
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    with open(out) as f:
        return json.load(f)


def test_two_process_mesh_matches_one_process_and_the_reference(worker_results, eight_devices):
    from ba_tpu_torch.parallel import make_mesh

    one = run_cases(make_mesh((4, 2), devices=["cpu"] * 8))
    ref = _reference_cases()
    assert set(worker_results) == set(one) == set(ref)
    for name in one:
        assert worker_results[name] == one[name] == ref[name], name
    assert np.asarray(one["sm_decision"]).size == B_NODE
