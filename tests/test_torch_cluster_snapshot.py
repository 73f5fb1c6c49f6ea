"""Cluster snapshots (``--state FILE``): the port's ``save_cluster`` /
``restore_cluster`` on the cases of ``tests/test_snapshot.py:44-104``,
and files that cross between the packages both ways — written by one,
restored by the other, and the next ``actual-order`` prints the same
lines in both."""

import io
import json
import sys

import pytest

from ba_tpu.runtime.backends import JaxBackend
from ba_tpu.runtime.cluster import Cluster as JCluster
from ba_tpu.runtime.repl import handle_command as j_handle_command
from ba_tpu.utils import snapshot as j_snapshot
from ba_tpu_torch.runtime.backends import PyBackend, TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.main import build_cluster, main
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.utils.snapshot import _backend_config, restore_cluster, save_cluster

SESSION = ["g-state 2 faulty", "g-kill 1", "g-add 2", "g-state 5 faulty",
           "actual-order attack"]  # leader G2, faulty: coin-sensitive rounds after it
NEXT = ["actual-order retreat", "actual-order attack", "g-kill 3", "actual-order attack"]


@pytest.fixture(scope="module")
def jax_backend():
    return JaxBackend(platform="cpu")


def drive(cluster, lines, handle=handle_command):
    out = []
    for line in lines:
        handle(cluster, line, out.append)
    return out


def test_cluster_json_roundtrip(tmp_path):
    c1 = Cluster(5, PyBackend(), seed=3)
    c1.set_faulty(2, True)
    c1.kill(1)  # leadership moves to 2
    c1.actual_order("attack")  # advances the round counter
    path = str(tmp_path / "cluster.json")
    save_cluster(path, c1)

    c2 = Cluster(1, PyBackend(), seed=0)
    restore_cluster(path, c2)
    assert [g.id for g in c2.generals] == [g.id for g in c1.generals]
    assert [g.faulty for g in c2.generals] == [g.faulty for g in c1.generals]
    assert c2.leader_id == c1.leader_id == 2
    assert c2._round == c1._round == 1
    assert c2._next_id == c1._next_id
    assert c1.actual_order("retreat") == c2.actual_order("retreat")


def test_restore_refuses_backend_config_mismatch(tmp_path):
    path = str(tmp_path / "sm.json")
    save_cluster(path, Cluster(4, TorchBackend(device="cpu", protocol="sm", m=2), seed=0))
    with pytest.raises(ValueError, match="backend config"):
        restore_cluster(path, Cluster(4, PyBackend(), seed=0))


def test_save_is_atomic_no_tmp_left(tmp_path):
    c = Cluster(3, PyBackend(), seed=0)
    path = tmp_path / "c.json"
    save_cluster(str(path), c)
    save_cluster(str(path), c)  # the overwrite goes through os.replace
    assert [p.name for p in tmp_path.iterdir()] == ["c.json"]


def test_cli_state_flag_restores_roster(tmp_path, monkeypatch):
    path = str(tmp_path / "state.json")
    monkeypatch.setattr(sys, "stdin", io.StringIO("g-kill 1\ng-add 1\nExit\n"))
    assert main(["3", "--backend", "py", "--state", path]) == 0
    cluster, state_path = build_cluster(["3", "--backend", "py", "--state", path])
    assert state_path == path
    assert [g.id for g in cluster.generals] == [2, 3, 4]
    assert cluster.leader_id == 2
    assert cluster._next_id == 5


def test_torch_backend_writes_the_formats_batched_backend_name():
    """A cuda and a torch backend write the same configuration, under the
    JAX package's class name for the batched device backend."""
    cluster = Cluster(3, TorchBackend(device="cpu", m=2), seed=0)
    assert _backend_config(cluster) == {"backend": "JaxBackend", "protocol": "om", "m": 2,
                                        "signed": False}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_crosses_packages(tmp_path, jax_backend, writer):
    port = Cluster(4, TorchBackend(device="cpu"), seed=5)
    ref = JCluster(4, jax_backend, seed=5)
    assert drive(port, SESSION) == drive(ref, SESSION, j_handle_command)
    path = str(tmp_path / "state.json")
    if writer == "port":
        save_cluster(path, port)
        restored = JCluster(2, jax_backend, seed=0)
        j_snapshot.restore_cluster(path, restored)
        want, got = drive(port, NEXT), drive(restored, NEXT, j_handle_command)
    else:
        j_snapshot.save_cluster(path, ref)
        restored = Cluster(2, TorchBackend(device="cpu"), seed=0)
        restore_cluster(path, restored)
        want, got = drive(ref, NEXT, j_handle_command), drive(restored, NEXT)
    assert json.load(open(path))["config"]["backend"] == "JaxBackend"
    assert got == want and len(got) == 6 + 6 + 5  # five generals, then four


def test_py_backend_snapshot_crosses_packages(tmp_path):
    from ba_tpu.runtime.backends import PyBackend as JPyBackend

    path = str(tmp_path / "py.json")
    c = Cluster(5, PyBackend(), seed=9)
    drive(c, SESSION)
    save_cluster(path, c)
    restored = JCluster(1, JPyBackend(), seed=0)
    j_snapshot.restore_cluster(path, restored)
    assert drive(restored, NEXT, j_handle_command) == drive(c, NEXT)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sm_m2_config_is_refused_across_packages(tmp_path, writer):
    path = str(tmp_path / "sm.json")
    if writer == "port":
        save_cluster(path, Cluster(4, TorchBackend(device="cpu", protocol="sm", m=2), seed=0))
        with pytest.raises(ValueError, match="backend config"):
            j_snapshot.restore_cluster(path, JCluster(4, JaxBackend(platform="cpu"), seed=0))
    else:
        j_snapshot.save_cluster(
            path, JCluster(4, JaxBackend(platform="cpu", protocol="sm", m=2), seed=0))
        with pytest.raises(ValueError, match="backend config"):
            restore_cluster(path, Cluster(4, TorchBackend(device="cpu"), seed=0))
    # the matching configuration restores
    if writer == "port":
        j_snapshot.restore_cluster(
            path, JCluster(4, JaxBackend(platform="cpu", protocol="sm", m=2), seed=0))
    else:
        restore_cluster(path, Cluster(4, TorchBackend(device="cpu", protocol="sm", m=2),
                                      seed=0))
