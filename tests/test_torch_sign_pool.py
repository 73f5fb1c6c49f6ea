"""The signing pool and the signature-table cache (``ba_tpu_torch/crypto/
pool.py``) against the in-process lane and ``ba_tpu``'s, on the CPU.

Held bit for bit: the pool's tables and verdicts against the in-process
bodies (one pool of 2 workers, shared by the module, its workers killed
by the last test), a lane over pool and cache against the reference's
lane, the cache's hits and its LRU (the same operations on the
reference's cache, step by step), a campaign over a half-dead pool.  A
subprocess shows that the worker's imports load neither jax nor torch.
"""

import io
import os
import pickle
import struct
import subprocess
import sys

import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.crypto import pool as j_pool
from ba_tpu.parallel import make_sweep_state
from ba_tpu.parallel import signing as j_signing
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.crypto import pool as pool_mod
from ba_tpu_torch.crypto import signed, tables
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel import signing
from ba_tpu_torch.parallel.signing import SignAheadLane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def reference_pool_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BA_TPU_SIGN_POOL", "0")
        j_pool.shutdown_defaults()
        yield
    j_pool.shutdown_defaults()
    pool_mod.shutdown_defaults()


@pytest.fixture(scope="module")
def pool():
    p = pool_mod.SignPool(2)
    yield p
    p.close()


def _tables(B, seed, rounds):
    sks, pks = tables.commander_keys(B, seed)

    def fallback(rs):
        return np.stack([tables.sign_round_tables(sks, pks, r)[1] for r in rs])

    msgs = np.concatenate([tables._round_table_msgs(B, r, 2, 0) for r in rounds])
    return sks, pks, fallback, msgs, np.tile(pks, (len(rounds), 1))


def test_pool_sign_and_verify_equal_the_inprocess_bodies(pool):
    B, seed, rounds = 6, 9, list(range(5))
    _, _, fallback, msgs, pks_w = _tables(B, seed, rounds)
    want = fallback(rounds)
    bad = want.reshape(len(rounds) * B, 2, 64).copy()
    bad[3, 1, 0] ^= 0xFF
    bad[11, 0, 5] ^= 0x01
    want_ok = tables.verify_host_exact(pks_w, msgs, bad)
    assert not want_ok.all() and want_ok.any()
    assert pool.workers == 2
    assert np.array_equal(pool.sign_rounds(seed, B, 2, 0, rounds, fallback), want)
    assert np.array_equal(pool.verify_rows(pks_w, msgs, bad), want_ok)
    assert pool.degraded == 0 and pool.shards == 4


def test_sharding_is_deterministic(pool):
    for n in (1, 2, 5, 8, 13):
        for parts in (1, 2, 3, 8):
            spans = pool_mod.SignPool._split(n, parts)
            assert spans == j_pool.SignPool._split(n, parts)
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(hi == lo2 and hi > lo for (lo, hi), (lo2, _) in zip(spans, spans[1:]))
    B, seed, rounds = 4, 17, list(range(1, 7))
    _, _, fallback, msgs, pks_w = _tables(B, seed, rounds)
    want = fallback(rounds)
    for cut in (rounds[:1], rounds[:2], rounds):  # 1 shard, 2, 2 of 3
        assert np.array_equal(pool.sign_rounds(seed, B, 2, 0, cut, fallback),
                              want[:len(cut)])
    flat = want.reshape(-1, 2, 64)
    assert np.array_equal(pool.verify_rows(pks_w[:1], msgs[:1], flat[:1]),
                          np.ones((1, 2), bool))


def test_lane_over_pool_and_cache_equals_the_reference_lane(pool):
    B, wins = 5, [(0, 3), (3, 4)]
    ref = j_signing.SignAheadLane(B, seed=4, pool=0, cache=0)
    want = [np.asarray(p) for p in ref.stage_windows(wins)]
    cache = pool_mod.SigTableCache(32)
    lane = SignAheadLane(B, seed=4, pool=pool, cache=cache, device="cpu")
    got = lane.stage_windows(wins)
    inproc = SignAheadLane(B, seed=4, pool=0, cache=0, device="cpu").stage_windows(wins)
    for w, g, i in zip(want, got, inproc):
        assert np.array_equal(w, g.numpy()) and torch.equal(g, i)
    assert lane.pool_workers == 2 and lane.pool_s > 0 and lane.sigs_signed == 4 * B * 2
    for r in range(4):
        key = pool_mod.SigTableCache.round_key(lane.pks, tables._round_table_msgs(B, r, 2, 0))
        sigs, ok = cache.get(key)
        assert np.array_equal(sigs, ref.round_tables(r)[1]) and ok is not None


def test_cache_hits_are_bit_exact_and_counted():
    B, wins = 4, [(0, 2), (2, 5)]
    cache = pool_mod.SigTableCache(32)
    lane = SignAheadLane(B, seed=6, pool=0, cache=cache, device="cpu")
    cold = lane.stage_windows(wins)
    assert (cache.misses, cache.hits) == (5, 0)
    warm = lane.stage_windows(wins)
    assert cache.hits == 5 and (lane.cache_hits, lane.cache_misses) == (5, 5)
    assert lane.sigs_signed == 5 * B * 2 and lane.sigs_verified == 5 * B * 2
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)
    other = SignAheadLane(B, seed=7, pool=0, cache=cache, device="cpu")
    other.stage(0, 2)
    assert (other.cache_hits, other.cache_misses) == (0, 2)  # the keys are in the key
    again = SignAheadLane(B, seed=6, pool=0, cache=cache, device="cpu")
    for a, b in zip(cold, again.stage_windows(wins)):
        assert torch.equal(a, b)
    assert again.cache_hits == 5


def test_cache_lru_evicts_as_the_reference_does():
    sigs, ok = np.zeros((2, 2, 64), np.uint8), np.ones((2, 2), bool)
    caches = [pool_mod.SigTableCache(max_entries=3), j_pool.SigTableCache(max_entries=3)]
    small = [pool_mod.SigTableCache(64, max_bytes=sigs.nbytes * 2),
             j_pool.SigTableCache(64, max_bytes=sigs.nbytes * 2)]
    ops = [("put", i) for i in range(5)] + [("get", 0), ("get", 4), ("get", 2), ("put", 5),
                                            ("get", 3), ("get", 2), ("put", 2)]
    trace = []
    for c in caches:
        steps = []
        for op, i in ops:
            if op == "put":
                c.put(bytes([i]) * 32, sigs, ok)
            else:
                steps.append(c.get(bytes([i]) * 32) is not None)
            steps.append((len(c), c.evictions, c.hits, c.misses, c.nbytes))
        trace.append(steps)
    assert trace[0] == trace[1]
    assert len(caches[0]) == 3 and caches[0].get(bytes([0]) * 32) is None
    for c in small:
        for i in range(4):
            c.put(bytes([i]) * 32, sigs, None)
    assert (small[0].nbytes, small[0].evictions) == (small[1].nbytes, small[1].evictions)
    assert small[0].nbytes <= sigs.nbytes * 2 and small[0].evictions >= 2
    with pytest.raises(ValueError):
        pool_mod.SigTableCache(0)


def test_lane_pool_and_cache_arguments(monkeypatch):
    lane = SignAheadLane(2, pool=0, cache=0, device="cpu")
    assert lane.pool is None and lane.cache is None and lane.pool_workers == 0
    assert pool_mod.default_workers() == max(0, min(8, (os.cpu_count() or 1) - 1))
    monkeypatch.setattr(pool_mod, "default_workers", lambda: 1)
    pool_mod.shutdown_defaults()
    try:
        lane = SignAheadLane(2, device="cpu")
        assert lane.pool is pool_mod.default_pool() and lane.pool_workers == 1
        assert lane.cache is pool_mod.default_cache() and lane.cache.max_entries == 256
        assert lane.cache.max_bytes == 128 << 20
    finally:
        pool_mod.shutdown_defaults()
    assert lane.pool.workers == 0  # closed
    with pytest.raises(ValueError):
        pool_mod.SignPool(-1)
    p = pool_mod.SignPool(1, timeout_s=5)
    p.close()
    p.close()
    assert p.workers == 0


@pytest.mark.parametrize("kw", [{"pool": 4}, {"pool": True}, {"pool": "0"}, {"cache": 4},
                                {"cache": True}, {"cache": {}}])
def test_lane_refuses_other_pool_and_cache_values(kw):
    """``pool=`` / ``cache=`` take an instance, None or 0 / False: any
    other value raises instead of turning the pool or cache off."""
    with pytest.raises(ValueError, match=next(iter(kw))):
        SignAheadLane(2, device="cpu", **{"pool": 0, "cache": 0, **kw})
    lane = SignAheadLane(2, pool=False, cache=False, device="cpu")
    assert lane.pool is None and lane.cache is None


def test_a_lane_on_the_card_verifies_on_the_card_whatever_signs(pool, monkeypatch):
    """A lane on the card with a live pool: the pool signs, and the
    verdicts come from ``verify_exact`` (K7, K5, K4, K3 on the card; the
    card's route is forced here, so their plain versions run), never from
    the pool's workers.  A corrupted signature is rejected as the host
    route rejects it."""
    wins = [(0, 1), (1, 2)]
    real = SignAheadLane._sign_inprocess

    def corrupt(sigs):
        sigs = sigs.copy()
        sigs[1, 1, 1, 0] ^= 0xFF
        return sigs

    monkeypatch.setattr(SignAheadLane, "_sign_inprocess",
                        lambda self, rounds: corrupt(real(self, rounds)))
    want = SignAheadLane(3, seed=8, pool=0, cache=0, device="cpu").stage_windows(wins)
    monkeypatch.setattr(SignAheadLane, "_sign_inprocess", real)
    pool_sign = pool.sign_rounds
    monkeypatch.setattr(pool, "sign_rounds", lambda *a: corrupt(pool_sign(*a)))

    def no_verify(*args):
        raise AssertionError("the pool verified for a lane on the card")

    monkeypatch.setattr(pool, "verify_rows", no_verify)
    monkeypatch.setattr(signed, "host_verify_route", lambda device=None: False)
    monkeypatch.setattr(signing, "host_verify_route", lambda device=None: False)
    lane = SignAheadLane(3, seed=8, pool=pool, cache=0, device="cpu")
    got = lane.stage_windows(wins)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int((~torch.cat(got)).sum()) == 1 and not bool(got[1][0, 1, 1])
    assert lane.pool_s > 0 and lane.sigs_signed == lane.sigs_verified == 2 * 3 * 2


def test_hoisted_key_rows_and_grouped_windows():
    lane = SignAheadLane(5, seed=12, pool=0, cache=0, device="cpu")
    sk_rep, pk_rep = tables.key_table_arrays(lane.sks, lane.pks, 2)
    assert np.array_equal(lane._sk_rep, sk_rep) and np.array_equal(lane._pk_rep, pk_rep)
    for r in (0, 3):
        assert np.array_equal(lane._sign_inprocess([r])[0], lane.round_tables(r)[1])
    a = SignAheadLane(5, seed=12, pool=0, cache=0, device="cpu")
    b = SignAheadLane(5, seed=12, pool=0, cache=0, device="cpu")
    grouped = a.stage_windows([(0, 2), (2, 4)])
    assert torch.equal(grouped[0], b.stage(0, 2)) and torch.equal(grouped[1], b.stage(2, 4))
    assert (a.windows, a.rounds_signed) == (2, 4)
    with pytest.raises(ValueError):
        a.stage_windows([])
    with pytest.raises(ValueError):
        a.stage(3, 3)


def test_worker_loads_neither_jax_nor_torch():
    """The worker's module run as ``python -m`` on a sign task, a verify
    task and ``exit`` from its stdin: its replies are the in-process
    bytes, and neither jax nor torch was imported."""
    B, seed = 3, 5
    sks, pks = tables.commander_keys(B, seed)
    msgs, sigs = tables.sign_round_tables(sks, pks, 4)
    frames = b"".join(
        struct.pack("<Q", len(blob)) + blob
        for blob in (pickle.dumps(task) for task in (
            ("sign", seed, B, 2, 0, [4]), ("verify", pks, msgs, sigs), ("exit",))))
    code = ("import io, runpy, sys\n"
            "sys.stdin = io.TextIOWrapper(io.BytesIO(sys.stdin.buffer.read()))\n"
            "runpy.run_module('ba_tpu_torch.crypto.pool', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'torch', 'ba_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], input=frames, capture_output=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    out = io.BytesIO(proc.stdout)
    replies = [pool_mod._recv(out), pool_mod._recv(out)]
    assert replies[0][0] == "ok" and np.array_equal(replies[0][1][0], sigs)
    assert replies[1][0] == "ok" and replies[1][1].all()


def test_dead_workers_degrade_counted_and_stay_bit_exact(pool):
    """Last in the module: kills the shared pool's workers one by one."""
    B, seed, rounds = 4, 23, list(range(4))
    _, _, fallback, _, _ = _tables(B, seed, rounds)
    want = fallback(rounds)
    arrays = {k: np.asarray(getattr(make_sweep_state(jr.key(3), 4, 8), k)).copy()
              for k in ("order", "leader", "faulty", "alive", "ids")}
    arrays["faulty"][::2, 0] = True

    def campaign(p):
        return tp.pipeline_sweep(rng.key(31, device="cpu"),
                                 convert.state_from_numpy(type("S", (), arrays), "cpu"), 6,
                                 signed=True, m=2, rounds_per_dispatch=2,
                                 collect_decisions=True, pool=p, cache=0, device="cpu")

    ref = campaign(0)
    pool._workers[0].proc.kill()
    pool._workers[0].proc.wait()
    assert np.array_equal(pool.sign_rounds(seed, B, 2, 0, rounds, fallback), want)
    assert pool.degraded == 1 and pool.workers == 1
    out = campaign(pool)  # a campaign over the half-dead pool
    for name in ("histograms", "decisions", "counters_per_round"):
        assert np.array_equal(out[name], ref[name]), name
    assert out["counters"] == ref["counters"] and out["stats"]["sign_pool_workers"] == 1
    pool._workers[1].proc.kill()
    pool._workers[1].proc.wait()
    assert np.array_equal(pool.sign_rounds(seed, B, 2, 0, rounds, fallback), want)
    assert pool.workers == 0 and pool.degraded == 2
    assert np.array_equal(pool.sign_rounds(seed, B, 2, 0, rounds, fallback), want)


def test_a_worker_that_cannot_start_raises(monkeypatch):
    monkeypatch.setattr(pool_mod.SignPool, "_spawn", staticmethod(
        lambda: subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, bufsize=0)))
    with pytest.raises(RuntimeError, match="did not start"):
        pool_mod.SignPool(2, timeout_s=30)
