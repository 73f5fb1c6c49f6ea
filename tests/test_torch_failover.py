"""``failover_sweep``, a kill-only campaign in one megastep, against
``ba_tpu``'s under ``jax.jit`` (XLA): at m = 1 on the shape of
tests/test_scenario.py's kill-only parity test and at m = 2 on
tests/test_parallel.py's; and against the port's own ``scenario_sweep``
over the same kills.  Inputs from numpy seeds; tolerance zero."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import make_state as j_make_state
from ba_tpu.core.types import ATTACK, RETREAT
from ba_tpu.parallel import failover_sweep as j_failover_sweep
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import make_state
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel.sweep import failover_sweep
from ba_tpu_torch.scenario.compile import block_from_kills

# m = 1: tests/test_scenario.py's shape; m = 2: tests/test_parallel.py's
CASES = {1: dict(B=24, n=8, R=7, faulty_col=4, order=ATTACK, p_kill=0.05, seed=3, key=13),
         2: dict(B=8, n=7, R=2, faulty_col=3, order=RETREAT, p_kill=0.0, seed=0, key=1)}

_j_failover = jax.jit(j_failover_sweep, static_argnums=(3,))


def _inputs(m):
    c = CASES[m]
    kills = np.random.default_rng(c["seed"]).random((c["R"], c["B"], c["n"])) < c["p_kill"]
    kills[1, :, 0] = True  # every leader dies before round 1
    faulty = np.zeros((c["B"], c["n"]), bool)
    faulty[:, c["faulty_col"]] = True
    return c, faulty, kills


def _tstate(c, faulty):
    return make_state(c["B"], c["n"], order=c["order"], faulty=torch.tensor(faulty),
                      device="cpu")


@pytest.mark.parametrize("m", [1, 2])
def test_failover_matches_the_reference(m):
    c, faulty, kills = _inputs(m)
    want = _j_failover(jr.key(c["key"]),
                       j_make_state(c["B"], c["n"], order=c["order"],
                                    faulty=jnp.asarray(faulty)),
                       jnp.asarray(kills), m)
    state = _tstate(c, faulty)
    kept = tp.fresh_copy(state)
    got = failover_sweep(rng.key(c["key"], device="cpu"), state, kills, m=m, device="cpu")
    for name in ("leaders", "decisions", "histograms"):
        assert np.array_equal(np.asarray(want[name]), got[name].numpy()), name
        assert got[name].dtype == getattr(torch, str(np.asarray(want[name]).dtype)), name
    for name, value in convert.state_to_numpy(got["final_state"]).items():
        assert np.array_equal(np.asarray(getattr(want["final_state"], name)), value), name
    for a, b in zip(kept.tensors(), state.tensors()):  # the caller's state is kept
        assert torch.equal(a, b)
    leaders = got["leaders"].numpy()
    assert (leaders[0] == np.where(kills[0, :, 0], leaders[0], 0)).all()
    assert (leaders[1] != 0).all()  # every instance failed over


@pytest.mark.parametrize("m", [1, 2])
def test_failover_matches_the_ports_scenario_sweep(m):
    c, faulty, kills = _inputs(m)
    got = failover_sweep(rng.key(c["key"], device="cpu"), _tstate(c, faulty),
                         torch.tensor(kills), m=m, device="cpu")
    want = tp.scenario_sweep(rng.key(c["key"], device="cpu"), _tstate(c, faulty),
                             block_from_kills(kills), m=m, depth=2, rounds_per_dispatch=3,
                             collect_decisions=True, device="cpu")
    for name in ("leaders", "decisions", "histograms"):
        assert np.array_equal(want[name], got[name].numpy()), name
    for a, b in zip(want["final_state"].tensors(), got["final_state"].tensors()):
        assert torch.equal(a, b)


def test_failover_validation():
    c, faulty, kills = _inputs(1)
    key, state = rng.key(0, device="cpu"), _tstate(c, faulty)
    with pytest.raises(ValueError, match="kill_schedule"):
        failover_sweep(key, state, kills[:, :3], device="cpu")
    with pytest.raises(ValueError, match="kill_schedule"):
        failover_sweep(key, state, kills[:0], device="cpu")
    with pytest.raises(ValueError, match="engine='cuda'"):
        failover_sweep(key, state, kills, engine="cuda", device="cpu")
    assert failover_sweep(key, state, kills, engine="torch",
                          device="cpu")["decisions"].shape == (c["R"], c["B"])
