"""The sign-ahead lane: each round's signature tables, signed and verified
while the signed megastep's dispatches are in flight
(``ba_tpu/parallel/signing.py``).

A round's signatures cover the commander's (at most V) distinct
round-bound claims, "commander of instance b says v in round r"
(``crypto/tables.round_message``), not the realized broadcast, so a
round's whole table is known before the round runs.
``pipeline_sweep(signed=True)`` stages window d + 1 through
:meth:`SignAheadLane.stage_windows` while dispatches d - depth .. d are
on the card, and the megastep consumes the per-round ``[B, V]`` verdict
planes as its inputs.

Two routes for the verdicts, chosen by the lane's device alone:

- **host route** (a lane on the CPU): verified on the host (the pool's
  workers when it has a live pool, else the native verifier in one
  call); the verdicts are numpy and kept in the cache beside the
  signatures;
- **device route** (a lane on the card): one exact verify of the whole
  group on the card (``crypto/signed.verify_exact``: K7, K5, K4 and K3),
  whose verdict planes stay lazy device tensors.  A live pool still
  signs; it never verifies for a lane on the card.

Neither route waits for the card.  A staging pass under an active trace
context is one span, a child of that context: its position rides each
pool task (``traceparent=``), so the workers' ``pool_task`` spans parent
under it, and with the sink on the pass writes one ``sign_ahead`` record
a window (and one ``sign_pool`` record with a pool) carrying that span.  :func:`sequential_signed_sweep` is the
blocking per-round driver the pipelined engine must reproduce bit for
bit; it derives its counters on the host in numpy
(:func:`_host_signed_counter_delta`), independently of the megastep's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.core.types import ATTACK, RETREAT, UNDEFINED
from ba_tpu_torch.crypto import pool as _pool_mod
from ba_tpu_torch.crypto.signed import host_verify_route, verify_exact
from ba_tpu_torch.crypto.tables import (
    _round_table_msgs,
    commander_keys,
    key_table_arrays,
    sign_round_tables,
    sign_table_msgs_arrays,
    verify_host_exact,
)
from ba_tpu_torch.obs import trace as _trace
from ba_tpu_torch.utils import metrics as _metrics


class SignAheadLane:
    """One commander key-set and its per-round table staging.

    Keys are made once, here.  :meth:`stage_windows` prepares any group
    of round windows: each round's table from the cache, else signed (by
    the pool, else in-process), then one verify of the whole group, and
    returns a bool ``[hi - lo, B, V]`` verdict plane a window on
    ``device`` (the card unless given).

    ``pool``: a ``SignPool`` is used as given, ``None`` takes the process
    default (``crypto/pool.default_pool``), ``0`` or ``False`` signs
    in-process.  ``cache``: a ``SigTableCache``, ``None`` for the process
    default (``default_cache``), ``0`` or ``False`` for none.  Any other
    value raises.
    Accounting: ``sign_ahead_s`` (the whole staging wall), ``sign_s``,
    ``verify_s``, ``pool_s``, ``cache_hits``, ``cache_misses``,
    ``sigs_signed``, ``sigs_verified``, ``windows``, ``rounds_signed``.
    """

    def __init__(self, batch: int, seed: int = 0, n_values: int = 2, pool=None, cache=None,
                 device=None):
        if batch < 1:
            raise ValueError(f"batch={batch} must be >= 1")
        if n_values < 1:
            raise ValueError(f"n_values={n_values} must be >= 1")
        self.batch = batch
        self.seed = seed
        self.n_values = n_values
        self.device = resolve_device(device)
        self.sks, self.pks = commander_keys(batch, seed)
        self._sk_rep, self._pk_rep = key_table_arrays(self.sks, self.pks, n_values)
        self.pool = _choose(pool, _pool_mod.SignPool, _pool_mod.default_pool, "pool")
        self.cache = _choose(cache, _pool_mod.SigTableCache, _pool_mod.default_cache, "cache")
        self.sign_ahead_s = 0.0
        self.sign_s = 0.0
        self.verify_s = 0.0
        self.pool_s = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self.sigs_signed = 0
        self.sigs_verified = 0
        self.windows = 0
        self.rounds_signed = 0

    @property
    def pool_workers(self) -> int:
        return self.pool.workers if self.pool is not None else 0

    def round_tables(self, round_index: int):
        """One round's (msgs, sigs) tables, host numpy."""
        return sign_round_tables(self.sks, self.pks, round_index, self.n_values)

    def stage(self, lo: int, hi: int) -> torch.Tensor:
        """Rounds ``[lo, hi)`` -> bool ``[hi - lo, B, V]`` verdicts."""
        return self.stage_windows([(lo, hi)])[0]

    def _sign_inprocess(self, rounds: list[int]) -> np.ndarray:
        """Sign the tables of ``rounds`` in one native batch call -> sigs
        [len(rounds), B, V, 64]; also a failed pool shard's body."""
        k = len(rounds)
        msgs = np.concatenate([_round_table_msgs(self.batch, r, self.n_values, 0)
                               for r in rounds])
        return sign_table_msgs_arrays(
            np.tile(self._sk_rep, (k, 1)), np.tile(self._pk_rep, (k, 1)), msgs,
        ).reshape(k, self.batch, self.n_values, 64)

    def _to_device(self, ok: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(ok))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def stage_windows(self, windows) -> list[torch.Tensor]:
        """Sign and verify a group of round windows ``[(lo, hi), ...]`` in
        one pass -> one bool ``[hi - lo, B, V]`` verdict plane a window.
        Never waits for the card.

        Each round's table is looked up in the cache first (a hit skips
        signing, and on the host route verifying); the misses of the
        whole group are signed together, split over the pool's workers
        (contiguous round ranges, reassembled by round) or in one native
        call; then one exact verify: on the host route of every round still
        unverified, by the pool's workers or the native verifier; on the
        device route of every round, by ``verify_exact`` on the card (K7,
        K5, K4, K3), whatever signed it.  The verify is exact by design:
        the batch check's accept / fallback decision would wait for the
        card, and its cofactored verdict depends on the batch, while the
        verdicts feed the ``sig_rejections`` counter.
        """
        if not windows:
            raise ValueError("stage_windows needs at least one window")
        for lo, hi in windows:
            if not 0 <= lo < hi:
                raise ValueError(f"bad sign-ahead window [{lo}, {hi})")
        t0 = time.perf_counter()
        # the pass's span, a child of the thread's context (the engine's
        # batch or campaign scope); untraced, none
        stage_ctx = _trace.child_context() if _trace.current() is not None else None
        traced = ({} if stage_ctx is None
                  else {"traceparent": _metrics.format_traceparent(stage_ctx[0], stage_ctx[1])})
        B, V = self.batch, self.n_values
        rounds = [r for lo, hi in windows for r in range(lo, hi)]
        msgs_by_r = {r: _round_table_msgs(B, r, V, 0) for r in rounds}
        pool_live = self.pool is not None and self.pool.workers > 0
        host_route = host_verify_route(self.device)
        sigs_by_r, ok_by_r, keys_by_r = {}, {}, {}
        hits = misses = 0
        if self.cache is not None:
            for r in rounds:
                keys_by_r[r] = _pool_mod.SigTableCache.round_key(self.pks, msgs_by_r[r])
                entry = self.cache.get(keys_by_r[r])
                if entry is None:
                    misses += 1
                else:
                    sigs_by_r[r], ok_by_r[r] = entry
                    hits += 1
        miss_rounds = [r for r in rounds if r not in sigs_by_r]

        t_sign = time.perf_counter()
        pool_s = 0.0
        if miss_rounds:
            if pool_live:
                p0 = time.perf_counter()
                signed_block = self.pool.sign_rounds(self.seed, B, V, 0, miss_rounds,
                                                     self._sign_inprocess, **traced)
                pool_s += time.perf_counter() - p0
            else:
                signed_block = self._sign_inprocess(miss_rounds)
            for i, r in enumerate(miss_rounds):
                sigs_by_r[r] = signed_block[i]
        sign_wall = time.perf_counter() - t_sign

        t_verify = time.perf_counter()
        if host_route:
            need = [r for r in rounds if ok_by_r.get(r) is None]
            if need:
                msgs_cat = np.concatenate([msgs_by_r[r] for r in need])
                sigs_cat = np.concatenate([sigs_by_r[r] for r in need])
                pks_w = np.tile(self.pks, (len(need), 1))
                if pool_live:
                    p0 = time.perf_counter()
                    ok_cat = self.pool.verify_rows(pks_w, msgs_cat, sigs_cat, **traced)
                    pool_s += time.perf_counter() - p0
                else:
                    ok_cat = verify_host_exact(pks_w, msgs_cat, sigs_cat)
                ok_cat = np.asarray(ok_cat, np.bool_).reshape(len(need), B, V)
                for i, r in enumerate(need):
                    ok_by_r[r] = ok_cat[i]
            if self.cache is not None:
                for r in miss_rounds:
                    self.cache.put(keys_by_r[r], sigs_by_r[r], ok_by_r[r])
            n_verified = len(need) * B * V
            planes = [self._to_device(np.stack([ok_by_r[r] for r in range(lo, hi)]))
                      for lo, hi in windows]
        else:
            if self.cache is not None:  # signatures only: the card verifies again
                for r in miss_rounds:
                    self.cache.put(keys_by_r[r], sigs_by_r[r], None)
            msgs_cat = np.concatenate([msgs_by_r[r] for r in rounds])
            sigs_cat = np.concatenate([sigs_by_r[r] for r in rounds])
            pks_w = np.tile(self.pks, (len(rounds), 1))
            n_verified = len(rounds) * B * V
            ok_all = verify_exact(pks_w, msgs_cat, sigs_cat, self.device)
            ok_all = ok_all.reshape(len(rounds), B, V)
            planes, cursor = [], 0
            for lo, hi in windows:
                planes.append(ok_all[cursor:cursor + hi - lo])
                cursor += hi - lo
        verify_wall = time.perf_counter() - t_verify
        wall = time.perf_counter() - t0
        if _metrics.default_sink().enabled:
            self._emit_records(windows, stage_ctx, t0, wall, hits, misses, sign_wall,
                               verify_wall, pool_s)

        self.sign_ahead_s += wall
        self.rounds_signed += len(rounds)
        self.windows += len(windows)
        self.sign_s += sign_wall
        self.verify_s += verify_wall
        self.pool_s += pool_s
        self.cache_hits += hits
        self.cache_misses += misses
        self.sigs_signed += len(miss_rounds) * B * V
        self.sigs_verified += n_verified
        return planes


    def _emit_records(self, windows, ctx, t0, wall, hits, misses, sign_wall, verify_wall,
                      pool_s) -> None:
        """One ``sign_ahead`` record a window (the pass's wall shared by
        round count) and, with a pool, one ``sign_pool`` record, stamped
        with the pass's own span: the thread's context is its parent."""
        stamp = {}
        if ctx is not None:
            stamp = {"trace_id": ctx[0], "span_id": ctx[1]}
            if ctx[2] is not None:
                stamp["parent_id"] = ctx[2]
        B, V = self.batch, self.n_values
        n_rounds = sum(hi - lo for lo, hi in windows)
        for lo, hi in windows:
            nr = hi - lo
            _metrics.emit({"event": "sign_ahead", "v": _metrics.SCHEMA_VERSION, "lo": lo,
                           "hi": hi, "batch": B, "values": V, "t_perf": round(t0, 6),
                           **stamp, "wall_s": round(wall * nr / n_rounds, 6),
                           "table_bytes": int(nr * B * V * (16 + 64))})
        if self.pool is not None:
            _metrics.emit({"event": "sign_pool", "v": _metrics.SCHEMA_VERSION,
                           "t_perf": round(t0, 6), **stamp, "workers": self.pool.workers,
                           "requested": self.pool.requested,
                           "degraded": self.pool.degraded, "rounds": n_rounds,
                           "cache_hits": hits, "cache_misses": misses,
                           "sign_s": round(sign_wall, 6), "verify_s": round(verify_wall, 6),
                           "pool_s": round(pool_s, 6)})


def _choose(value, kind, default, name):
    """``pool=`` / ``cache=``: an instance of ``kind``, ``None`` for the
    process default, ``0`` / ``False`` for none; anything else raises."""
    if value is None:
        return default()
    if isinstance(value, kind):
        return value
    if value is False or (type(value) is int and value == 0):
        return None
    raise ValueError(f"{name}={value!r}: give a {kind.__name__}, None (the process default) "
                     f"or 0 / False (none)")


def _keys_at(key: torch.Tensor, round_index: int, batch: int) -> torch.Tensor:
    """Round ``round_index``'s per-instance keys under the engine's
    schedule, ``fold_in(fold_in(base, r), i)`` (``pipeline.round_keys``)."""
    from ba_tpu_torch.parallel.pipeline import make_key_schedule, round_keys

    return round_keys(make_key_schedule(key, round_index), batch)


def _host_signed_counter_delta(decision, majorities, received, ok, alive, faulty, leader):
    """One round's SIGNED_COUNTER_NAMES increments derived on the host in
    numpy from the fetched streams, independently of the megastep's
    ``signed_counter_delta``, so the bit-match cross-checks both."""
    B, n = majorities.shape
    idx = np.arange(n)[None, :]
    lieutenants = alive & (idx != leader[:, None])
    quorum_failures = int((decision == UNDEFINED).sum())
    counts = [int((decision == RETREAT).sum()), int((decision == ATTACK).sum()),
              int((decision == UNDEFINED).sum())]
    unanimous = int(max(counts) == B)
    big = np.int64(127)
    maj = majorities.astype(np.int64)
    mmax = np.where(lieutenants, maj, -big).max(axis=1)
    mmin = np.where(lieutenants, maj, big).min(axis=1)
    disagree = (mmax != mmin) & lieutenants.any(axis=1)
    traitor_present = (faulty & alive).any(axis=1)
    equivocation = int((disagree & traitor_present).sum())
    sig_rej = int((~ok).any(axis=1).sum())
    got_a = ((received == ATTACK) & lieutenants).any(axis=1)
    got_r = ((received == RETREAT) & lieutenants).any(axis=1)
    rows = np.arange(B)
    leader_faulty = faulty[rows, leader]
    leader_alive = alive[rows, leader]
    cmd_equiv = int((got_a & got_r & leader_faulty & leader_alive).sum())
    return np.array([quorum_failures, unanimous, equivocation, sig_rej, cmd_equiv], np.int64)


def sequential_signed_sweep(key: torch.Tensor, state: SimState, rounds: int, *, m: int = 1,
                            collapsed: bool = False, sign_seed: int = 0,
                            collect_decisions: bool = True, lane: SignAheadLane | None = None,
                            device=None) -> dict:
    """The blocking per-round signed driver, the behaviour the pipelined
    engine must reproduce bit for bit (``ba_tpu/parallel/signing.py:453``).

    Each round in series: sign the round's tables (the lane's), verify
    them exactly on ``device`` (the card unless given; ``verify_exact``)
    and fetch the verdicts, run one ``signed_agreement_step`` under the
    engine's key schedule, fetch its outputs.  Only the lane's tables are
    used, so the lane made when ``lane`` is None has no pool and no cache.

    Returns ``histograms`` [R, 3], ``decisions`` [R, B] (with
    ``collect_decisions``), ``counters`` ({name: int} over
    SIGNED_COUNTER_NAMES, derived on the host), ``majorities`` [B, n]
    (the last round's) and ``timings`` (cumulative ``sign_s``,
    ``verify_s``, ``step_s``).
    """
    from ba_tpu_torch.parallel.pipeline import SIGNED_COUNTER_NAMES
    from ba_tpu_torch.parallel.sweep import signed_agreement_step

    dev = resolve_device(device)
    key, state = key.to(dev), state.to(dev)
    B, n = state.faulty.shape
    if lane is None:
        lane = SignAheadLane(B, seed=sign_seed, pool=0, cache=0, device=dev)
    alive = state.alive.cpu().numpy()
    faulty = state.faulty.cpu().numpy()
    leader = state.leader.cpu().numpy()
    hists = np.zeros((rounds, 3), np.int64)
    decisions = np.zeros((rounds, B), np.int64)
    counters = np.zeros(len(SIGNED_COUNTER_NAMES), np.int64)
    majorities = None
    sign_s = verify_s = step_s = 0.0
    for r in range(rounds):
        t0 = time.perf_counter()
        msgs, sigs = lane.round_tables(r)
        t1 = time.perf_counter()
        ok_dev = verify_exact(lane.pks, msgs, sigs, dev)
        ok = ok_dev.cpu().numpy()  # the blocking fetch this driver is the baseline for
        t2 = time.perf_counter()
        out = signed_agreement_step(_keys_at(key, r, B), state, ok_dev, m=m,
                                    collapsed=collapsed)
        decision = out["decision"].cpu().numpy()
        maj = out["majorities"].cpu().numpy()
        received = out["received"].cpu().numpy()
        hists[r] = out["histogram"].cpu().numpy()
        t3 = time.perf_counter()
        decisions[r] = decision
        majorities = maj
        counters += _host_signed_counter_delta(decision, maj, received, ok, alive, faulty,
                                               leader)
        sign_s += t1 - t0
        verify_s += t2 - t1
        step_s += t3 - t2
    result = {
        "histograms": hists,
        "majorities": majorities,
        "counters": {name: int(v) for name, v in zip(SIGNED_COUNTER_NAMES, counters)},
        "timings": {"sign_s": round(sign_s, 6), "verify_s": round(verify_s, 6),
                    "step_s": round(step_s, 6)},
    }
    if collect_decisions:
        result["decisions"] = decisions
    return result
