"""The signed SM(m) pipelined engine and its sign-ahead lane against
``ba_tpu`` (the XLA engine), on the CPU.

Held bit for bit, tolerance zero: the round-bound tables (messages and
signatures), ``signed_agreement_step`` at m = 1 and 2 on both relays with
rejected table signatures, ``sign_round1`` / ``signed_sm_agreement``,
``pipeline_sweep(signed=True)`` (decisions, histograms, counters, final
state) and the port's own ``sequential_signed_sweep``, counters across
dispatch sizes, signed carry checkpoints across packages both ways,
signed cohorts (``coalesced_sweep(signed=True)``), and the host shell's
signed ``run-rounds``.  The reference's signing pool is off
(``BA_TPU_SIGN_POOL=0``); the port passes ``pool=0``.  B <= 8, capacity
<= 16, R <= 12.
"""

import re

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.crypto import pool as j_pool
from ba_tpu.crypto import signed as j_signed
from ba_tpu.parallel import make_sweep_state
from ba_tpu.parallel import pipeline as jp
from ba_tpu.parallel import signing as j_signing
from ba_tpu.parallel.sweep import signed_agreement_step as j_signed_step
from ba_tpu.runtime.backends import JaxBackend
from ba_tpu.runtime.cluster import Cluster as JCluster
from ba_tpu.runtime.repl import handle_command as j_handle_command
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.crypto import pool as t_pool
from ba_tpu_torch.crypto import signed, tables
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel import signing
from ba_tpu_torch.parallel.sweep import signed_agreement_step
from ba_tpu_torch.runtime.backends import TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.scenario import compile as t_compile
from ba_tpu_torch.scenario import spec as t_spec
from ba_tpu_torch.utils import snapshot

B, CAP, R, RPD = 8, 8, 9, 4
CPU = dict(device="cpu", pool=0)
STATE_FIELDS = ("order", "leader", "faulty", "alive", "ids")


@pytest.fixture(scope="module", autouse=True)
def reference_pool_off():
    """The reference's lane takes its pool from the environment: off, so
    no test starts cpu_count - 1 reference workers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BA_TPU_SIGN_POOL", "0")
        j_pool.shutdown_defaults()
        yield
    j_pool.shutdown_defaults()


def _arrays(batch=B, cap=CAP, seed=3):
    """A sweep state with every other leader faulty, so the commander
    equivocation verdicts fire."""
    state = make_sweep_state(jr.key(seed), batch, cap)
    arrays = {k: np.asarray(getattr(state, k)).copy() for k in STATE_FIELDS}
    arrays["faulty"][::2, 0] = True
    return arrays


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), "cpu")


def _same_run(ref, out, names=("histograms", "decisions", "counters_per_round")):
    for name in names:
        assert np.array_equal(np.asarray(ref[name]), np.asarray(out[name])), name
    assert ref["counters"] == out["counters"]
    for name in STATE_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref["final_state"], name)),
                              getattr(out["final_state"], name).numpy()), name
    assert int(ref["final_schedule"].counter) == int(out["final_schedule"].counter)


# -- the round-bound tables ------------------------------------------------------


def test_round_tables_are_the_reference_bytes():
    for batch, r, values, base in ((5, 7, 2, 3), (1, 0, 2, 0), (3, 2**32 - 1, 3, 9)):
        msgs = tables._round_table_msgs(batch, r, values, base)
        assert np.array_equal(msgs, j_signed._round_table_msgs(batch, r, values, base))
        for b in range(batch):
            for v in range(values):
                assert msgs[b, v].tobytes() == tables.round_message(base + b, r, v) \
                    == j_signed.round_message(base + b, r, v)
    assert tables.round_message(0, 0, 0)[:4] != tables.order_message(0, 0)[:4]
    sks, pks = signed.commander_keys(4, seed=1)
    j_sks, j_pks = j_signed.commander_keys(4, seed=1)
    assert sks == j_sks and np.array_equal(pks, j_pks)
    for got, want in zip(tables.key_table_arrays(sks, pks, 2),
                         j_signed.key_table_arrays(j_sks, j_pks, 2)):
        assert np.array_equal(got, want)
    for r in (0, 1, 5):
        got, want = signed.sign_round_tables(sks, pks, r), j_signed.sign_round_tables(sks, pks, r)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    m0, s0 = signed.sign_round_tables(sks, pks, 0)
    m1, s1 = signed.sign_round_tables(sks, pks, 1)
    assert not np.array_equal(m0, m1) and not np.array_equal(s0, s1)  # the round is bound
    assert np.array_equal(signed.verify_host_exact(pks, m0, s0), np.ones((4, 2), bool))


# -- one signed round --------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("collapsed", [False, True])
def test_signed_agreement_step_matches_the_reference(m, collapsed):
    arrays = _arrays()
    ok = np.random.default_rng(m + 2 * collapsed).random((B, 2)) > 0.3
    assert not ok.all()
    keys = jp.round_keys(jp.make_key_schedule(jr.key(11), 5), B)
    want = jax.jit(j_signed_step, static_argnames=("m", "collapsed"))(
        keys, _jstate(arrays), jnp.asarray(ok), m=m, collapsed=collapsed)
    t_keys = tp.round_keys(tp.make_key_schedule(rng.key(11, device="cpu"), 5), B)
    got = signed_agreement_step(t_keys, _tstate(arrays), convert.verdicts_from_numpy(ok, "cpu"),
                                m=m, collapsed=collapsed)
    for name in ("majorities", "decision", "needed", "total", "histogram", "received"):
        assert np.array_equal(np.asarray(want[name]), got[name].numpy()), name


@pytest.mark.parametrize("values", [1, 3])
def test_signed_agreement_step_takes_two_values(values):
    """The round gates by the reference's V = 2 select alone: verdict
    tables of any other width raise."""
    keys = tp.round_keys(tp.make_key_schedule(rng.key(11, device="cpu"), 0), B)
    with pytest.raises(ValueError, match="V = 2"):
        signed_agreement_step(keys, _tstate(_arrays()), torch.ones(B, values, dtype=torch.bool))


@pytest.mark.parametrize("dedup", [False, True])
def test_sign_round1_and_signed_sm_agreement_match_the_reference(dedup):
    arrays = _arrays(seed=5)
    corrupt = None if dedup else np.random.default_rng(1).random((B, CAP)) < 0.2
    want = j_signed.sign_round1(jr.key(4), _jstate(arrays), 2, corrupt, dedup)
    got = signed.sign_round1(rng.key(4, device="cpu"), _tstate(arrays), 2, corrupt, dedup)
    assert np.array_equal(np.asarray(jr.key_data(want[0])), got[0].numpy())
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(w), g.numpy())
    if not dedup:
        assert not got[2].all()
    for m, collapsed in ((1, False), (2, True)):
        want = j_signed.signed_sm_agreement(jr.key(6), _jstate(arrays), m, corrupt=corrupt,
                                            collapsed=collapsed)
        got = signed.signed_sm_agreement(rng.key(6, device="cpu"), _tstate(arrays), m,
                                         corrupt=corrupt, collapsed=collapsed)
        for name in ("majorities", "decision", "sig_valid"):
            assert np.array_equal(np.asarray(want[name]), got[name].numpy()), name


# -- the pipelined engine -----------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("collapsed", [False, True])
def test_pipeline_sweep_signed_matches_the_reference(m, collapsed):
    arrays = _arrays()
    kw = dict(signed=True, m=m, collapsed=collapsed, depth=2, rounds_per_dispatch=RPD,
              collect_decisions=True)
    ref = jp.pipeline_sweep(jr.key(11), _jstate(arrays), R, engine="xla", **kw)
    out = tp.pipeline_sweep(rng.key(11, device="cpu"), _tstate(arrays), R, **kw, **CPU)
    _same_run(ref, out)
    assert list(out["counters"]) == list(tp.SIGNED_COUNTER_NAMES)
    assert out["counters"]["commander_equivocations"] > 0
    assert out["stats"]["signed"] is True and out["stats"]["engine"] == "torch"
    assert out["stats"]["sign_ahead_s"] > 0 and out["stats"]["run_id"] == ref["stats"]["run_id"]
    seq = signing.sequential_signed_sweep(rng.key(11, device="cpu"), _tstate(arrays), R, m=m,
                                          collapsed=collapsed, device="cpu")
    assert np.array_equal(seq["decisions"], out["decisions"])
    assert np.array_equal(seq["histograms"], out["histograms"])
    assert seq["counters"] == out["counters"]  # derived on the host, independently
    want = j_signing.sequential_signed_sweep(jr.key(11), _jstate(arrays), R, m=m,
                                             collapsed=collapsed)
    assert np.array_equal(np.asarray(want["majorities"]), seq["majorities"])


def test_rejected_table_signatures_are_counted(monkeypatch):
    """A lane whose round 2 table carries a corrupted signature: the
    engine, the sequential driver and the reference's scan count the same
    rejections and gate the same values."""
    arrays = _arrays()
    real = signing.SignAheadLane._sign_inprocess

    def corrupt(self, rounds):
        sigs = real(self, rounds)
        for i, r in enumerate(rounds):
            if r == 2:
                sigs[i, 1::3, 1, 0] ^= 0xFF
        return sigs

    monkeypatch.setattr(signing.SignAheadLane, "_sign_inprocess", corrupt)
    out = tp.pipeline_sweep(rng.key(7, device="cpu"), _tstate(arrays), 4, signed=True,
                            rounds_per_dispatch=2, collect_decisions=True, cache=0, **CPU)
    assert out["counters"]["sig_rejections"] == len(range(1, B, 3))
    ok = signing.SignAheadLane(B, pool=0, cache=0, device="cpu").stage(0, 4)
    assert int((~ok).any(dim=-1).sum()) == len(range(1, B, 3))
    state = jp.fresh_copy(_jstate(arrays))
    want = jp.signed_megastep(state, jp.make_key_schedule(jr.key(7)), jp.signed_counters_init(),
                              jnp.asarray(ok.numpy()), rounds=4, collect_decisions=True)
    assert np.array_equal(np.asarray(want[3]), out["decisions"])
    assert np.array_equal(np.asarray(want[4][-1]), out["counters_per_round"][-1])


def test_signed_counters_continue_across_dispatches():
    arrays = _arrays(6, CAP, seed=8)
    one = tp.pipeline_sweep(rng.key(21, device="cpu"), _tstate(arrays), 8, signed=True,
                            rounds_per_dispatch=8, **CPU)
    many = tp.pipeline_sweep(rng.key(21, device="cpu"), _tstate(arrays), 8, signed=True,
                             rounds_per_dispatch=3, **CPU)
    assert one["counters"] == many["counters"]
    assert np.array_equal(one["counters_per_round"], many["counters_per_round"])
    assert (one["stats"]["dispatches"], many["stats"]["dispatches"]) == (1, 3)
    seq = signing.sequential_signed_sweep(rng.key(21, device="cpu"), _tstate(arrays), 8,
                                          device="cpu")
    assert seq["counters"] == one["counters"]


def test_sign_ahead_windows_and_coalescing(monkeypatch):
    """Window d + 1 is staged right after dispatch d, up to
    ``sign_coalesce`` windows a lane pass; every grouping gives the same
    bits, and the dispatch / retire order keeps ``depth`` in flight."""
    arrays = _arrays(4, CAP)
    groups = []
    real = signing.SignAheadLane.stage_windows
    monkeypatch.setattr(signing.SignAheadLane, "stage_windows",
                        lambda self, w: groups.append(list(w)) or real(self, w))
    runs = {}
    for coalesce in (1, 3):
        events = []
        groups.clear()
        runs[coalesce] = tp.pipeline_sweep(
            rng.key(23, device="cpu"), _tstate(arrays), 7, signed=True, depth=3,
            rounds_per_dispatch=1, sign_coalesce=coalesce, collect_decisions=True, cache=0,
            on_event=lambda kind, i: events.append((kind, i)), **CPU)
        assert groups == [[(r, r + 1) for r in range(lo, min(lo + coalesce, 7))]
                          for lo in range(0, 7, coalesce)]
        first_retire = events.index(("retire", 0))
        assert events[:first_retire] == [("dispatch", i) for i in range(4)]
        assert runs[coalesce]["stats"]["max_in_flight"] == 4
    _same_run(runs[1], runs[3])
    with pytest.raises(ValueError, match="sign_coalesce"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 2, signed=True,
                          sign_coalesce=0, **CPU)


def test_device_route_equals_host_route(monkeypatch):
    """The lane's device route (one ``verify_exact`` of the group on the
    lane's device: K7, K5, K4, K3 on the card, their plain versions here)
    gives the host route's verdicts, corrupted signatures included."""
    lane_host = signing.SignAheadLane(3, seed=4, pool=0, cache=0, device="cpu")
    real = signing.SignAheadLane._sign_inprocess

    def corrupt(self, rounds):
        sigs = real(self, rounds)
        sigs[0, 1, 0, 5] ^= 1
        return sigs

    monkeypatch.setattr(signing.SignAheadLane, "_sign_inprocess", corrupt)
    want = lane_host.stage_windows([(0, 1), (1, 2)])
    monkeypatch.setattr(signed, "host_verify_route", lambda device=None: False)
    monkeypatch.setattr(signing, "host_verify_route", lambda device=None: False)
    lane_dev = signing.SignAheadLane(3, seed=4, pool=0, cache=0, device="cpu")
    got = lane_dev.stage_windows([(0, 1), (1, 2)])
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert not bool(got[0][0, 1, 0]) and int((~torch.cat(got)).sum()) == 1


def test_signed_engine_rules():
    arrays = _arrays(4, CAP)
    with pytest.raises(ValueError, match="signed"):
        tp.pipeline_sweep(rng.key(1, device="cpu"), _tstate(arrays), 2, signed=True,
                          engine="cuda", **CPU)
    block = t_compile.compile_scenario(t_spec.from_dict({"name": "x", "rounds": 2,
                                                         "events": []}), 4, CAP)
    with pytest.raises(ValueError, match="scenario"):
        tp.pipeline_sweep(rng.key(1, device="cpu"), _tstate(arrays), 2, signed=True,
                          scenario=block, **CPU)
    with pytest.raises(ValueError, match="collapsed"):
        tp.pipeline_sweep(rng.key(1, device="cpu"), _tstate(arrays), 2, collapsed=True,
                          device="cpu")
    one = {k: v[:1] for k, v in arrays.items()}
    with pytest.raises(ValueError, match="signed"):
        tp.coalesced_sweep([rng.key(1, device="cpu")], _tstate(one), 2, signed=True,
                           engine="cuda", **CPU)
    with pytest.raises(ValueError, match="collapsed"):
        tp.coalesced_sweep([rng.key(1, device="cpu")], _tstate(one), 2, collapsed=True,
                           device="cpu")
    assert tp.engine_support(1, signed=True) is not None
    assert tp.resolve_engine(None, torch.device("cuda"), 1, signed=True) == "torch"


# -- signed carry checkpoints ------------------------------------------------------


def test_signed_checkpoint_resume_is_bit_exact(tmp_path):
    path = str(tmp_path / "ck_{round}.npz")
    arrays = _arrays(6, CAP, seed=9)
    kw = dict(signed=True, m=2, rounds_per_dispatch=3, collect_decisions=True, **CPU)
    full = tp.pipeline_sweep(rng.key(9, device="cpu"), _tstate(arrays), 12,
                             checkpoint_every=6, checkpoint_path=path, **kw)
    ck = tp.load_carry_checkpoint(path.format(round=6), "cpu")
    assert ck.signed and ck.round == 6 and ck.counters.shape == (5,)
    for resume in (ck, path.format(round=6)):
        tail = tp.pipeline_sweep(None, None, 12, resume=resume, **kw)
        assert np.array_equal(tail["histograms"], full["histograms"][6:])
        assert np.array_equal(tail["decisions"], full["decisions"][6:])
        assert tail["counters"] == full["counters"]
        assert tail["stats"]["run_id"] == full["stats"]["run_id"]
    meta = snapshot.validate_carry_checkpoint(path.format(round=12))
    assert meta["signed"] and meta["counter_names"] == list(tp.SIGNED_COUNTER_NAMES)


@pytest.fixture(scope="module")
def signed_campaign(tmp_path_factory):
    """One signed campaign (B = 8, capacity 8, m = 2, 12 rounds 3 a
    dispatch, a checkpoint every 6) run by both packages."""
    d = tmp_path_factory.mktemp("signed")
    arrays = _arrays(seed=12)
    kw = dict(signed=True, m=2, rounds_per_dispatch=3, collect_decisions=True,
              checkpoint_every=6)
    j_path, t_path = str(d / "j_{round}.npz"), str(d / "t_{round}.npz")
    j_out = jp.pipeline_sweep(jr.key(12), _jstate(arrays), 12, engine="xla",
                              checkpoint_path=j_path, **kw)
    t_out = tp.pipeline_sweep(rng.key(12, device="cpu"), _tstate(arrays), 12,
                              checkpoint_path=t_path, **kw, **CPU)
    return dict(j_out=j_out, t_out=t_out, j_path=j_path, t_path=t_path, dir=d)


def test_signed_checkpoints_are_the_same_file(signed_campaign):
    _same_run(signed_campaign["j_out"], signed_campaign["t_out"])
    for cursor in (6, 12):
        j_meta, j_arrays = snapshot.read_carry_checkpoint(
            signed_campaign["j_path"].format(round=cursor))
        t_meta, t_arrays = snapshot.read_carry_checkpoint(
            signed_campaign["t_path"].format(round=cursor))
        assert j_meta == t_meta and j_meta["signed"]
        assert sorted(j_arrays) == sorted(t_arrays)
        for name, want in j_arrays.items():
            assert want.dtype == t_arrays[name].dtype and np.array_equal(want, t_arrays[name])


@pytest.mark.parametrize("writer", ["ba_tpu", "ba_tpu_torch"])
def test_signed_checkpoint_resumes_across_packages(signed_campaign, writer):
    path = signed_campaign["j_path" if writer == "ba_tpu" else "t_path"].format(round=6)
    kw = dict(signed=True, m=2, rounds_per_dispatch=3, collect_decisions=True)
    full = signed_campaign["j_out"]
    port = tp.pipeline_sweep(None, None, 12, resume=path, **kw, **CPU)
    ref = jp.pipeline_sweep(None, None, 12, resume=jp.load_carry_checkpoint(path),
                            engine="xla", **kw)
    for tail in (port, ref):
        assert np.array_equal(np.asarray(tail["decisions"]), np.asarray(full["decisions"])[6:])
        assert np.array_equal(np.asarray(tail["histograms"]),
                              np.asarray(full["histograms"])[6:])
        assert tail["counters"] == full["counters"]
    _same_run(ref, port)


def test_signed_carries_never_cross_protocols(signed_campaign, tmp_path):
    """Both packages refuse a signed carry in an oral sweep and an oral
    carry in a signed one, whichever package wrote it."""
    oral = str(tmp_path / "oral_{round}.npz")
    tp.pipeline_sweep(rng.key(6, device="cpu"), _tstate(_arrays(seed=7)), 6,
                      with_counters=True, rounds_per_dispatch=3, checkpoint_every=3,
                      checkpoint_path=oral, device="cpu")
    oral = oral.format(round=3)
    for signed_path in (signed_campaign["j_path"], signed_campaign["t_path"]):
        signed_path = signed_path.format(round=6)
        with pytest.raises(ValueError, match="crosses protocols"):
            tp.pipeline_sweep(None, None, 12, resume=signed_path, with_counters=True,
                              rounds_per_dispatch=3, device="cpu")
        with pytest.raises(ValueError, match="protocol"):
            jp.pipeline_sweep(None, None, 12, resume=jp.load_carry_checkpoint(signed_path),
                              with_counters=True, rounds_per_dispatch=3, engine="xla")
    with pytest.raises(ValueError, match="crosses protocols"):
        tp.pipeline_sweep(None, None, 6, resume=oral, signed=True, rounds_per_dispatch=3, **CPU)
    with pytest.raises(ValueError, match="protocol"):
        jp.pipeline_sweep(None, None, 6, resume=jp.load_carry_checkpoint(oral), signed=True,
                          rounds_per_dispatch=3, engine="xla")


# -- signed cohorts --------------------------------------------------------------------


def _alone(n, faulty, order, cap=4):
    arrays = dict(order=np.full(1, order, np.int8), leader=np.zeros(1, np.int32),
                  faulty=np.zeros((1, cap), bool), alive=np.zeros((1, cap), bool),
                  ids=np.arange(1, cap + 1, dtype=np.int32)[None])
    arrays["alive"][0, :n] = True
    arrays["faulty"][0, list(faulty)] = True
    return arrays


REQS = [(4, (2,), 1, 11), (3, (), 0, 12), (4, (0, 3), 1, 13)]


@pytest.mark.parametrize("m,collapsed", [(2, False), (1, True)])
def test_signed_coalesced_parity(m, collapsed):
    rows = [_alone(n, f, o) for n, f, o, _ in REQS]
    batch = {k: np.concatenate([r[k] for r in rows]) for k in STATE_FIELDS}
    kw = dict(rounds=5, rounds_per_dispatch=2, signed=True, m=m, collapsed=collapsed)
    co = tp.coalesced_sweep([rng.key(s, device="cpu") for *_, s in REQS], _tstate(batch),
                            **kw, **CPU)
    ref = jp.coalesced_sweep([jr.key(s) for *_, s in REQS], _jstate(batch), engine="xla", **kw)
    assert co["counter_names"] == ref["counter_names"] == list(tp.SIGNED_COUNTER_NAMES)
    for name in ("decisions", "majorities", "counters"):
        assert np.array_equal(np.asarray(ref[name]), co[name]), name
    for i, (n, f, o, s) in enumerate(REQS):
        alone = tp.pipeline_sweep(rng.key(s, device="cpu"), _tstate(rows[i]), 5, signed=True,
                                  m=m, collapsed=collapsed, rounds_per_dispatch=2,
                                  collect_decisions=True, **CPU)
        assert np.array_equal(co["decisions"][:, i], alone["decisions"][:, 0])
        assert dict(zip(co["counter_names"], co["counters"][i].tolist())) == alone["counters"]
        solo = tp.coalesced_sweep([rng.key(s, device="cpu")], _tstate(rows[i]), **kw, **CPU)
        assert np.array_equal(co["majorities"][i], solo["majorities"][0])
    with pytest.raises(ValueError, match="scenario"):
        tp.coalesced_sweep([rng.key(1, device="cpu")], _tstate(rows[0]), 2, signed=True,
                           scenario={"kill": np.zeros((2, 1, 4), bool)}, **CPU)


# -- the host shell -------------------------------------------------------------------


def test_repl_signed_run_rounds_matches_the_reference(monkeypatch):
    """``run-rounds`` on a signed SM(1) backend at n = 4 and 5 (a faulty
    general, a faulty leader): every line equal to the reference's, the
    ``Signed lane:`` line with its ``sign_ahead_s`` value masked.  The
    port's default pool has no workers here."""
    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    t_pool.shutdown_defaults()
    mask = re.compile(r"sign_ahead_s=[0-9.e-]+")
    ref_backend = JaxBackend(platform="cpu", protocol="sm", signed=True)
    for n, script in ((4, ["g-state 2 faulty", "run-rounds attack 8"]),
                      (5, ["g-state 1 faulty", "run-rounds retreat 6", "actual-order attack",
                           "run-rounds attack 3"])):
        port = Cluster(n, TorchBackend(device="cpu", protocol="sm", signed=True), seed=0)
        ref = JCluster(n, ref_backend, seed=0)
        got, want = [], []
        for line in script:
            handle_command(port, line, got.append)
            j_handle_command(ref, line, want.append)
        assert [mask.sub("sign_ahead_s=*", x) for x in got] == \
            [mask.sub("sign_ahead_s=*", x) for x in want]
        assert sum(x.startswith("Signed lane: sign_ahead_s=") for x in got) == \
            sum(line.startswith("run-rounds") for line in script)
        assert port._round == ref._round
