"""OM(m) by the EIG tree (``ba_tpu_torch/core/eig.py``) and K9's plain
version (``ba_tpu_torch/ops/majority.py``) against ``ba_tpu`` on the CPU.

Every piece of the tree — the send levels, the resolve, the Binomial
popcount draw, the fused deepest level, whole rounds at m in {0, 1, 2,
3} fused and dense, with and without strategies — in both key modes
(one key over the batch, as the benches call ``eig_agreement``; one key
a row, as ``agreement_step`` does); BASELINE config #2's shape at B = 16;
a case at n = 300, where tallies pass 256; and the sweeps at m = 2
against the reference's ``engine="xla"``, each coalesced slot also
against its own B = 1 run.  K9's plain version is held against the
reference's Pallas kernel in interpret mode and its jnp reference.
Tolerance is zero: every output is integer.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import eig as j_eig
from ba_tpu.core.quorum import strict_majority as j_strict_majority
from ba_tpu.core.state import SimState as JState
from ba_tpu.ops.majority import masked_majority_rows as j_masked_majority_rows
from ba_tpu.parallel import pipeline as jp
from ba_tpu.parallel import sweep as j_sweep
from ba_tpu.scenario import compile as j_compile
from ba_tpu_torch import convert
from ba_tpu_torch.core import eig, rng
from ba_tpu_torch.core.types import ATTACK, RETREAT, UNDEFINED
from ba_tpu_torch.ops import majority
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel import sweep


def _arrays(seed, B, n, *, faulty_leaders=True, p_faulty=0.35):
    rs = np.random.default_rng(seed)
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=(rs.integers(0, n, B) if faulty_leaders else np.zeros(B)).astype(np.int32),
        faulty=rs.random((B, n)) < p_faulty,
        alive=rs.random((B, n)) < 0.85,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    arrays["alive"][0] = False  # an all-dead row
    return arrays, rs


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), "cpu")


def _eq(jax_value, torch_value, what=""):
    if isinstance(torch_value, torch.Tensor):
        torch_value = torch_value.numpy()
    assert np.array_equal(np.asarray(jax_value), torch_value), what


def _row_keys(seed, B):
    """One key a row, both packages: fold_in(key(seed), b)."""
    j = jax.vmap(jr.fold_in, in_axes=(None, 0))(jr.key(seed), jnp.arange(B, dtype=jnp.uint32))
    t = rng.fold_in(rng.key(seed, device="cpu")[None, :], torch.arange(B))
    return j, t


def _config2(B):
    """BASELINE config #2's state (bench.py:161): n = 10, order ATTACK,
    generals 2, 5 and 7 faulty."""
    faulty = np.zeros((B, 10), bool)
    faulty[:, [2, 5, 7]] = True
    return dict(order=np.full(B, ATTACK, np.int8), leader=np.zeros(B, np.int32),
                faulty=faulty, alive=np.ones((B, 10), bool),
                ids=np.tile(np.arange(1, 11, dtype=np.int32), (B, 1)))


# -- K9's plain version --------------------------------------------------------


def _majority_ref(answers, valid, fallback):
    """tests/test_ops.py's jnp reference of the masked majority."""
    att = ((answers == ATTACK) & valid).sum(axis=1)
    ret = ((answers == RETREAT) & valid).sum(axis=1)
    maj = j_strict_majority(jnp.asarray(att), jnp.asarray(ret))
    return np.where(valid.sum(axis=1) > 0, np.asarray(maj), fallback)


@pytest.mark.parametrize("R,K", [(64, 7), (300, 33), (256, 128), (5, 1)])
def test_majority_plain_matches_reference_kernel(R, K):
    rs = np.random.default_rng(4 + K)
    answers = rs.integers(-3, 4, (R, K)).astype(np.int8)  # codes beyond 0..2 count as neither
    valid = rs.random((R, K)) < 0.6
    valid[:5] = False  # zero-eligible rows take the fallback
    fallback = rs.integers(0, 3, (R,)).astype(np.int8)
    before = majority.masked_majority_rows.launches
    got = majority.masked_majority_rows(torch.tensor(answers), torch.tensor(valid),
                                        torch.tensor(fallback))
    assert majority.masked_majority_rows.launches == before  # the CPU branch launches nothing
    assert got.dtype == torch.int8
    _eq(_majority_ref(answers, valid, fallback), got)
    want = j_masked_majority_rows(jnp.asarray(answers), jnp.asarray(valid),
                                  jnp.asarray(fallback), interpret=True)
    _eq(want, got)


def test_majority_ties_unanimity_and_shared_mask():
    answers = np.asarray([[ATTACK, RETREAT, UNDEFINED, UNDEFINED],
                          [ATTACK, ATTACK, RETREAT, ATTACK],
                          [RETREAT, RETREAT, RETREAT, ATTACK]], np.int8)
    got = majority.masked_majority_rows(torch.tensor(answers), torch.ones(3, 4, dtype=torch.bool),
                                        torch.full((3,), ATTACK, dtype=torch.int8))
    assert got.tolist() == [UNDEFINED, ATTACK, RETREAT]
    # the shared-mask form equals the dense form on the broadcast mask
    rs = np.random.default_rng(9)
    G, S, P, K = 3, 5, 4, 6
    a = torch.tensor(rs.integers(0, 3, (G, S, P, K)).astype(np.int8))
    v = torch.tensor(rs.random((G, 1, P, K)) < 0.5)
    v[0, 0, 0] = False
    f = torch.tensor(rs.integers(0, 3, (G, S, P)).astype(np.int8))
    shared = majority.masked_majority_rows(a, v, f)
    dense = majority.masked_majority_rows(a.reshape(-1, K), v.expand(G, S, P, K).reshape(-1, K),
                                          f.reshape(-1))
    assert shared.shape == (G, S, P) and torch.equal(shared.reshape(-1), dense)
    for bad in ((a, v.expand(G, S, P, K), f), (a, v, f[:, :, :1]), (a[..., :0], v[..., :0], f),
                (a[0], v[0], f[0])):
        with pytest.raises(ValueError):
            majority.masked_majority_rows(*bad)


# -- the pieces of the tree ------------------------------------------------------


@pytest.mark.parametrize("n,level", [(4, 0), (4, 2), (3, 3), (10, 2)])
def test_static_path_tables_match(n, level):
    _eq(j_eig._in_path_mask(n, level), eig._in_path_mask(n, level))
    if not level:  # no digits to correct (the fused level is at m - 1 >= 1)
        return
    j_digits, j_first = j_eig._path_digit_first(n, level)
    digits, first = eig._path_digit_first(n, level)
    _eq(j_digits.astype(np.int64), digits)
    _eq(j_first, first)


@pytest.mark.parametrize("per_row", [False, True])
def test_send_resolve_and_fused_level_match(per_row):
    B, n, m = 6, 5, 3
    arrays, rs = _arrays(1, B, n)
    strat = rs.integers(0, 6, (B, n)).astype(np.int8)
    js, ts = _jstate(arrays), _tstate(arrays)
    if per_row:  # one key a row: the reference's B = 1 calls, row by row
        jk, tk = _row_keys(3, B)

        def ref(fn):
            outs = jax.vmap(lambda k, s: fn(k, jax.tree.map(lambda x: x[None], s)))(jk, js)
            return jax.tree.map(lambda x: x.reshape(B, *x.shape[2:]), outs)
    else:
        jk, tk = jr.key(3), rng.key(3, device="cpu")

        def ref(fn):
            return jax.jit(fn)(jk, js)

    j_strat = None if per_row else jnp.asarray(strat)  # strategies in the one-key mode
    j_levels = ref(lambda k, s: j_eig.eig_send(k, s, m, j_strat))
    t_levels = eig.eig_send(tk, ts, m, None if per_row else torch.tensor(strat))
    assert len(t_levels) == m + 1
    for lv, (a, b) in enumerate(zip(j_levels, t_levels)):
        _eq(a, b, f"level {lv}")
    j_maj = jax.jit(j_eig.eig_resolve)(js, j_levels)
    _eq(j_maj, eig.eig_resolve(ts, t_levels))
    for max_liars in (None, 2):
        j_res = ref(lambda k, s: j_eig.eig_deepest_fused(
            k, s, j_eig.eig_send(k, s, m - 1), m, max_liars))
        t_res = eig.eig_deepest_fused(tk, ts, eig.eig_send(tk, ts, m - 1), m, max_liars)
        _eq(j_res, t_res, f"fused, max_liars {max_liars}")


@pytest.mark.parametrize("max_k", [0, 3, 31, 32, 33, 70])
def test_binomial_half_matches(max_k):
    rs = np.random.default_rng(max_k)
    k = rs.integers(0, max_k + 1, (4, 3, 5)).astype(np.int32)
    draw = jax.jit(j_eig._binomial_half, static_argnums=2)
    got = eig._binomial_half(rng.key(7, device="cpu"), torch.tensor(k), max_k)
    _eq(draw(jr.key(7), jnp.asarray(k), max_k), got)
    assert got.dtype == torch.int32 and bool((got <= torch.tensor(k)).all())
    jk, tk = _row_keys(8, 4)  # one key a row: row b's own [1, 3, 5] draw
    rows = jax.vmap(lambda kb, xb: draw(kb, xb[None], max_k)[0])(jk, jnp.asarray(k))
    _eq(rows, eig._binomial_half(tk, torch.tensor(k), max_k))


# -- whole rounds ------------------------------------------------------------------


@pytest.mark.parametrize("with_strategies", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_eig_round_matches(m, fused, with_strategies, monkeypatch):
    B, n = 7, 5
    arrays, rs = _arrays(10 + m, B, n)
    strat = rs.integers(0, 6, (B, n)).astype(np.int8) if with_strategies else None
    monkeypatch.setenv("BA_TPU_EIG_FUSED", "1" if fused else "0")
    # a fresh function a case: jit caches by function, and the reference
    # reads BA_TPU_EIG_FUSED while it traces
    want = jax.jit(lambda k, s, st: j_eig.eig_round(k, s, m, 2, st))(
        jr.key(m), _jstate(arrays), None if strat is None else jnp.asarray(strat))
    got = eig.eig_round(rng.key(m, device="cpu"), _tstate(arrays), m, 2,
                        None if strat is None else torch.tensor(strat), fused=fused)
    _eq(want, got)


@pytest.mark.parametrize("fused", [True, False])
def test_config2_shape_matches_and_holds_ic(fused, monkeypatch):
    """BASELINE config #2 at B = 16: one key over the batch, max_liars
    from the state; OM(3) with 3 traitors of 10 decides ATTACK."""
    arrays = _config2(16)
    max_liars = int(arrays["faulty"].sum(-1).max())
    monkeypatch.setenv("BA_TPU_EIG_FUSED", "1" if fused else "0")
    key = jr.fold_in(jr.key(1), 3)
    want = jax.jit(lambda k, s: j_eig.eig_agreement(k, s, 3, max_liars))(key, _jstate(arrays))
    got = eig.eig_agreement(rng.fold_in(rng.key(1, device="cpu"), 3), _tstate(arrays), 3,
                            max_liars, fused=fused)
    assert set(got) == set(want)
    for name in want:
        _eq(want[name], got[name], name)
    assert (got["decision"] == ATTACK).all()
    assert (got["needed"] == 7).all() and (got["total"] == 10).all()


def test_n300_tallies_past_256_match():
    B, n, m = 2, 300, 2
    faulty = np.zeros((B, n), bool)
    faulty[:, [4, 150]] = True
    arrays = dict(order=np.array([ATTACK, RETREAT], np.int8), leader=np.zeros(B, np.int32),
                  faulty=faulty, alive=np.ones((B, n), bool),
                  ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)))
    want = jax.jit(lambda k, s: j_eig.eig_agreement(k, s, m, 2))(jr.key(30), _jstate(arrays))
    got = eig.eig_agreement(rng.key(30, device="cpu"), _tstate(arrays), m, 2)
    for name in want:
        _eq(want[name], got[name], name)
    assert got["decision"].tolist() == [ATTACK, RETREAT]


@pytest.mark.parametrize("with_strategies", [False, True])
@pytest.mark.parametrize("m", [2, 3])
def test_agreement_step_per_row_keys_match(m, with_strategies):
    B, n = 9, 6
    arrays, rs = _arrays(20 + m, B, n)
    strat = rs.integers(0, 6, (B, n)).astype(np.int8) if with_strategies else None
    jk, tk = _row_keys(40 + m, B)
    want = jax.jit(j_sweep.agreement_step, static_argnums=(2, 3))(
        jk, _jstate(arrays), m, 2, None if strat is None else jnp.asarray(strat))
    got = sweep.agreement_step(tk, _tstate(arrays), m, 2,
                               None if strat is None else torch.tensor(strat))
    for name in ("majorities", "decision", "needed", "total", "histogram"):
        _eq(want[name], got[name], name)


# -- the sweeps at m = 2 -------------------------------------------------------------


def test_pipeline_sweep_m2_matches_xla():
    """tests/test_pipeline.py:85's case: make_sweep_state at capacity 8,
    traitors at most a quarter, OM(2) decides the order every round."""
    B, cap, R = 16, 8, 4
    jstate = j_sweep.make_sweep_state(jr.key(2), B, cap, min_n=8, max_traitor_frac=0.25,
                                      order=ATTACK)
    arrays = {k: np.asarray(getattr(jstate, k)) for k in ("order", "leader", "faulty", "alive",
                                                          "ids")}
    kw = dict(m=2, max_liars=2, depth=2, rounds_per_dispatch=3, collect_decisions=True,
              with_counters=True)
    want = jp.pipeline_sweep(jr.key(13), _jstate(arrays), R, engine="xla", **kw)
    got = tp.pipeline_sweep(rng.key(13, device="cpu"), _tstate(arrays), R, device="cpu", **kw)
    for name in ("histograms", "decisions", "counters_per_round"):
        _eq(want[name], got[name], name)
    assert (got["histograms"][:, 1] == B).all()
    assert got["stats"]["engine"] == "torch"


def test_scenario_sweep_m2_matches_xla():
    B, n, R = 5, 6, 4
    arrays, rs = _arrays(31, B, n)
    kill = rs.random((R, B, n)) < 0.1
    events = dict(kill=kill, revive=(rs.random((R, B, n)) < 0.1) & ~kill,
                  set_faulty=np.where(rs.random((R, B, n)) < 0.2,
                                      rs.integers(0, 2, (R, B, n)), -1).astype(np.int8),
                  set_strategy=np.where(rs.random((R, B, n)) < 0.3,
                                        rs.integers(0, 5, (R, B, n)), -1).astype(np.int8))
    strat = rs.integers(0, 5, (B, n)).astype(np.int8)
    block = j_compile.ScenarioBlock(**events)
    kw = dict(m=2, depth=2, rounds_per_dispatch=3, collect_decisions=True)
    want = jp.scenario_sweep(jr.key(32), _jstate(arrays), block, engine="xla",
                             initial_strategy=jnp.asarray(strat), **kw)
    got = tp.scenario_sweep(rng.key(32, device="cpu"), _tstate(arrays),
                            convert.block_from_numpy(block), device="cpu",
                            initial_strategy=torch.tensor(strat), **kw)
    for name in ("histograms", "decisions", "leaders", "counters_per_round", "final_counters"):
        _eq(want[name], got[name], name)
    _eq(want["final_strategy"], got["final_strategy"])


def test_coalesced_sweep_m2_matches_xla_and_each_slot_alone():
    B, n, R = 4, 5, 3
    arrays, _ = _arrays(33, B, n, faulty_leaders=False, p_faulty=0.25)
    seeds = [300 + b for b in range(B)]
    kw = dict(m=2, max_liars=n - 1, rounds_per_dispatch=2)
    want = jp.coalesced_sweep([jr.key(s) for s in seeds], _jstate(arrays), R, engine="xla",
                              **kw)
    got = tp.coalesced_sweep([rng.key(s, device="cpu") for s in seeds], _tstate(arrays), R,
                             device="cpu", **kw)
    for name in ("decisions", "majorities", "counters"):
        _eq(want[name], got[name], name)
    assert got["stats"]["engine"] == "torch"
    for b, seed in enumerate(seeds):
        alone = tp.coalesced_sweep([rng.key(seed, device="cpu")],
                                   _tstate({k: v[b:b + 1] for k, v in arrays.items()}), R,
                                   device="cpu", **kw)
        assert np.array_equal(got["decisions"][:, b:b + 1], alone["decisions"]), b
        assert np.array_equal(got["majorities"][b], alone["majorities"][0]), b
        assert np.array_equal(got["counters"][b], alone["counters"][0]), b


def test_explicit_cuda_engine_at_m2_raises_before_the_carry_is_touched():
    arrays, _ = _arrays(34, 3, 4)
    state = _tstate(arrays)
    kept = tp.fresh_copy(state)
    for call in (
        lambda: tp.pipeline_sweep(rng.key(0, device="cpu"), state, 2, m=2, engine="cuda",
                                  device="cpu"),
        lambda: tp.coalesced_sweep([rng.key(s, device="cpu") for s in range(3)], state, 2,
                                   m=3, engine="cuda", device="cpu"),
    ):
        with pytest.raises(ValueError, match="EIG tree"):
            call()
    for name in ("faulty", "alive", "leader"):
        assert torch.equal(getattr(kept, name), getattr(state, name))
    assert tp.resolve_engine(None, torch.device("cuda"), 2) == "torch"
    assert tp.resolve_engine(None, torch.device("cuda"), 1) == "cuda"
