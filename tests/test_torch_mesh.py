"""The port's meshes, sharded values and per-shard runner
(``ba_tpu_torch/parallel/mesh.py``, ``multihost.py``, ``shard.py``'s
helpers) against ``ba_tpu``'s on its 8-device CPU mesh: ``make_mesh``'s
shapes and errors, ``put_global`` round trips, ``shard_layout``,
``expand_counters``, ``reduce_host_ys`` and ``per_shard_nbytes(_all)`` on
meshes of equal shape.  Tolerance zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ba_tpu.parallel import make_mesh as j_make_mesh
from ba_tpu.parallel import put_global as j_put_global
from ba_tpu.parallel import shard as j_shard
from ba_tpu_torch.parallel import make_global_mesh, make_mesh, put_global
from ba_tpu_torch.parallel import mesh as M
from ba_tpu_torch.parallel import shard as t_shard

CPU = torch.device("cpu")
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]


def _meshes(shape):
    return j_make_mesh(shape, ("data", "node")), make_mesh(shape, devices=[CPU] * 8)


def test_make_mesh_shapes(eight_devices):
    mesh = make_mesh(devices=[CPU] * 8)
    assert mesh.shape == {"data": 8, "node": 1} and mesh.axis_names == ("data", "node")
    for shape in SHAPES:
        mesh = make_mesh(shape, devices=[CPU] * 8)
        assert mesh.devices.shape == shape
        assert tuple(mesh.shape.values()) == shape
        assert mesh.shape == dict(j_make_mesh(shape, ("data", "node")).shape)
        assert len(mesh.local_positions) == shape[0] * shape[1] and mesh.group is None
    one = make_mesh((3,), ("data",), devices=["cpu"] * 3)
    assert one.shape == {"data": 3}


def test_make_mesh_errors_name_the_counts():
    # tests/test_parallel.py:274
    with pytest.raises(ValueError, match=r"needs 999 .* 8"):
        make_mesh((999, 1), ("data", "node"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="all-positive"):
        make_mesh((0, 1), ("data", "node"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="axis"):
        make_mesh((2, 2, 2), ("data", "node"), devices=[CPU] * 8)


def test_default_devices_are_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_global_mesh()


def test_global_mesh_of_one_process_is_the_local_mesh():
    mesh = make_global_mesh(node_devices_per_host=2, devices=[CPU] * 8)
    assert mesh.devices.shape == (4, 2) and mesh.axis_names == ("data", "node")
    assert mesh.group is None and len(mesh.local_positions) == 8
    with pytest.raises(ValueError, match="must divide"):
        make_global_mesh(node_devices_per_host=3, devices=[CPU] * 8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec,dims", [(("data",), (16,)), (("data", None), (16, 6)),
                                       (("data", "node"), (16, 8)), ((), (3,)),
                                       ((None, "data", None), (3, 16, 4))])
def test_put_global_round_trips(shape, spec, dims):
    mesh = make_mesh(shape, devices=[CPU] * 8)
    x = torch.arange(int(np.prod(dims)), dtype=torch.int32).reshape(dims)
    s = put_global(mesh, x, M.P(*spec))
    assert s.shape == tuple(dims) and s.dtype == torch.int32
    assert torch.equal(s.gather(), x) and np.array_equal(np.asarray(s), x.numpy())
    for pos, piece in s.pieces.items():
        assert torch.equal(piece, x[s.block(pos)]) and piece.is_contiguous()
    assert put_global(mesh, s, M.P(*spec)) is s  # the same layout: no copy
    moved = put_global(mesh, s, M.P())
    assert torch.equal(next(iter(moved.pieces.values())), x)
    next(iter(s.pieces.values())).fill_(-1)  # the pieces are copies
    assert int(x.min()) == 0


def test_put_global_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        put_global(make_mesh((4, 1), devices=[CPU] * 4), torch.zeros(6), M.P("data"))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_shard_helpers_match_the_reference(eight_devices, shape):
    j_mesh, t_mesh = _meshes(shape)
    assert t_shard.shard_layout(t_mesh) == j_shard.shard_layout(j_mesh)
    assert t_shard.validate_mesh(t_mesh, 16) == j_shard.validate_mesh(j_mesh, 16)
    block = np.array([5, 3, 2, 7, 1], np.int32)
    for counters in (block, np.tile(block, (3, 1))):  # canonical, and a live [d', C] carry
        want = np.asarray(j_shard.expand_counters(j_mesh, jnp.asarray(counters)))
        got = t_shard.expand_counters(t_mesh, torch.as_tensor(counters))
        assert got.shape == want.shape and np.array_equal(np.asarray(got), want)
        assert tuple(got.spec) == ("data", None)
    rs = np.random.default_rng(0)
    d = shape[0]
    for scenario, decisions, counters in ((False, True, True), (True, True, True),
                                          (False, False, True), (False, True, False)):
        ys = [rs.integers(0, 9, (4, d, 3)).astype(np.int32)]
        if scenario:
            ys += [rs.integers(0, 8, (4, 16)).astype(np.int32),
                   rs.integers(0, 9, (4, d, 5)).astype(np.int32)]
        if decisions:
            ys.append(rs.integers(0, 3, (4, 16)).astype(np.int8))
        if counters and not scenario:
            ys.append(rs.integers(0, 9, (4, d, 3)).astype(np.int32))
        kw = dict(scenario=scenario, collect_decisions=decisions, with_counters=counters)
        want = j_shard.reduce_host_ys(tuple(ys), **kw)
        got = t_shard.reduce_host_ys(tuple(ys), **kw)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    arrays = {"a": (np.zeros((16, 8), np.int32), ("data", None)),
              "b": (np.zeros((16, 8), np.int8), ("data", "node")),
              "c": (np.zeros(2, np.int32), ()), "d": (np.zeros((3, 16), bool), (None, "data"))}
    j_tree = {k: j_put_global(j_mesh, v, JP(*spec)) for k, (v, spec) in arrays.items()}
    t_tree = {k: put_global(t_mesh, torch.as_tensor(v), M.P(*spec))
              for k, (v, spec) in arrays.items()}
    assert t_shard.per_shard_nbytes(t_tree) == j_shard.per_shard_nbytes(j_tree)
    assert t_shard.per_shard_nbytes_all(t_tree) == j_shard.per_shard_nbytes_all(j_tree)


def test_shard_map_collectives_and_errors():
    mesh = make_mesh((4, 2), devices=[CPU] * 8)
    x = put_global(mesh, torch.arange(32).reshape(8, 4), M.P("data", "node"))

    def body(x):
        d, n = M.axis_index("data"), M.axis_index("node")
        total = M.psum(x.sum(), "data")
        row = M.all_gather(x, "node", axis=1)
        return x * 0 + 10 * d + n, total[None], row

    ids, total, rows = M.shard_map(body, mesh, (M.P("data", "node"), M.P("node"),
                                                M.P("data")))(x)
    want_ids = np.array([[10 * (i // 2) + j // 2 for j in range(4)] for i in range(8)])
    assert np.array_equal(np.asarray(ids), want_ids)
    # the node-0 column's blocks and the node-1 column's sums
    cols = np.arange(32).reshape(8, 4)
    assert np.asarray(total).tolist() == [int(cols[:, :2].sum()), int(cols[:, 2:].sum())]
    assert np.array_equal(np.asarray(rows), cols)

    def broken(x):
        if M.axis_index("data") == 2:
            raise KeyError("shard 2")
        return M.psum(x, "data")

    with pytest.raises(KeyError, match="shard 2"):  # the others do not wait forever
        M.shard_map(broken, mesh, M.P("data", "node"))(x)
    with pytest.raises(RuntimeError, match="collectives=False"):
        M.shard_map(lambda x: M.psum(x, "data"), mesh, M.P("data", "node"),
                    collectives=False)(x)
    with pytest.raises(RuntimeError, match="inside a shard_map body"):
        M.psum(torch.zeros(1), "data")
