"""The node-sharded protocols on the port's 8-entry CPU mesh against
``ba_tpu``'s on its 8-device CPU mesh of the same (4, 2) shape:
``om1_node_sharded``, ``eig_node_sharded``, ``sm_node_sharded``
(collapsed, exact, exact under a withhold schedule, pinned round 1 and
signature mask) and ``signed_sm_agreement_sharded``.  Their coins are
keyed by (data, node) shard, so equal shapes give equal bits.  Inputs
come from numpy seeds; tolerance zero."""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.parallel import eig_node_sharded as j_eig
from ba_tpu.parallel import make_mesh as j_make_mesh
from ba_tpu.parallel import om1_node_sharded as j_om1
from ba_tpu.parallel import sm_node_sharded as j_sm
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.parallel import eig_node_sharded, make_mesh, om1_node_sharded, sm_node_sharded

CPU = torch.device("cpu")
KEYS = ("majorities", "decision", "needed", "total", "n_attack", "n_retreat", "n_undefined")


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return j_make_mesh((4, 2), ("data", "node")), make_mesh((4, 2), devices=[CPU] * 8)


def _arrays(seed, B, n, faulty_p=0.3, alive_p=0.9, faulty_leaders=True):
    rs = np.random.default_rng(seed)
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=(rs.integers(0, n, B) if faulty_leaders else np.zeros(B)).astype(np.int32),
        faulty=rs.random((B, n)) < faulty_p,
        alive=rs.random((B, n)) < alive_p,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    return arrays, rs


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), CPU)


def _same(j_out, t_out, keys=KEYS):
    for k in keys:
        assert np.array_equal(np.asarray(j_out[k]), np.asarray(t_out[k])), k


@pytest.mark.parametrize("seed,B,n", [(0, 8, 16), (1, 4, 6), (2, 12, 32)])
def test_om1_node_sharded_matches_reference(meshes, seed, B, n):
    arrays, _ = _arrays(seed, B, n)
    j_out = j_om1(meshes[0], jr.key(seed + 5), _jstate(arrays))
    t_out = om1_node_sharded(meshes[1], rng.key(seed + 5, CPU), _tstate(arrays))
    _same(j_out, t_out)
    assert t_out["majorities"].shape == (B, n)


@pytest.mark.parametrize("seed,B,n,m", [(0, 8, 8, 2), (1, 4, 6, 1), (2, 4, 4, 3)])
def test_eig_node_sharded_matches_reference(meshes, seed, B, n, m):
    arrays, _ = _arrays(seed, B, n)
    j_out = j_eig(meshes[0], jr.key(seed), _jstate(arrays), m)
    t_out = eig_node_sharded(meshes[1], rng.key(seed, CPU), _tstate(arrays), m)
    _same(j_out, t_out)


@pytest.mark.parametrize("collapsed", [True, False])
@pytest.mark.parametrize("seed,B,n,m", [(0, 8, 16, 3), (1, 4, 8, 1), (2, 8, 6, 2)])
def test_sm_node_sharded_matches_reference(meshes, seed, B, n, m, collapsed):
    arrays, _ = _arrays(seed, B, n)
    j_out = j_sm(meshes[0], jr.key(seed + 7), _jstate(arrays), m, collapsed=collapsed)
    t_out = sm_node_sharded(meshes[1], rng.key(seed + 7, CPU), _tstate(arrays), m,
                            collapsed=collapsed)
    _same(j_out, t_out)


def test_sm_node_sharded_pinned_round1_signatures_and_withhold(meshes):
    B, n, m = 8, 8, 2
    arrays, rs = _arrays(3, B, n)
    received = rs.integers(0, 2, (B, n)).astype(np.int8)
    sig_valid = rs.random((B, n)) < 0.8
    withhold = rs.random((m, B, n, n, 2)) < 0.5
    for kw in (dict(collapsed=True), dict(collapsed=False, withhold=withhold)):
        j_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        t_kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        j_out = j_sm(meshes[0], jr.key(11), _jstate(arrays), m, received=jnp.asarray(received),
                     sig_valid=jnp.asarray(sig_valid), **j_kw)
        t_out = sm_node_sharded(meshes[1], rng.key(11, CPU), _tstate(arrays), m,
                                received=torch.as_tensor(received),
                                sig_valid=torch.as_tensor(sig_valid), **t_kw)
        _same(j_out, t_out)
    with pytest.raises(ValueError, match="withhold"):
        sm_node_sharded(meshes[1], rng.key(0, CPU), _tstate(arrays), m,
                        withhold=torch.as_tensor(withhold))


def test_node_axis_must_divide_n(meshes):
    arrays, _ = _arrays(4, 4, 5)
    with pytest.raises(ValueError, match="must divide n=5"):
        om1_node_sharded(meshes[1], rng.key(0, CPU), _tstate(arrays))


@pytest.fixture(scope="module")
def no_reference_pool():
    import ba_tpu.crypto.pool as j_pool

    mp = pytest.MonkeyPatch()
    mp.setenv("BA_TPU_SIGN_POOL", "0")
    j_pool.shutdown_defaults()
    yield
    mp.undo()
    j_pool.shutdown_defaults()


def test_signed_sm_agreement_sharded_matches_reference(meshes, no_reference_pool):
    from ba_tpu.crypto.signed import signed_sm_agreement_sharded as j_signed
    from ba_tpu_torch.crypto.signed import signed_sm_agreement_sharded

    B, n, m = 4, 8, 2
    arrays, rs = _arrays(5, B, n, faulty_leaders=True)
    corrupt = rs.random((B, n)) < 0.2
    j_out = j_signed(meshes[0], jr.key(3), _jstate(arrays), m, corrupt=corrupt, seed=4)
    t_out = signed_sm_agreement_sharded(meshes[1], rng.key(3, CPU), _tstate(arrays), m,
                                        corrupt=corrupt, seed=4)
    _same(j_out, t_out, KEYS + ("sig_valid",))
    assert not np.asarray(t_out["sig_valid"]).all()  # the corrupted copies were rejected
