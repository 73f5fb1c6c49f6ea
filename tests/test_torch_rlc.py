"""The port's batch verify (``ba_tpu_torch/crypto/ed25519.verify_rlc`` and
its parts: ``scalar.mul_mod_l`` / ``sum_mod_l``, ``batch_point_sum``,
K3''s plain version ``ops/ladder.plain_window_mult``) and the ``"rlc"``
routes of ``crypto/signed.py``, against ``ba_tpu`` on the CPU (its jnp
path under ``jax.jit``, one jitted reference a function), Python integers
and the oracle.  Tolerance zero: bytes, verdicts and compressed
encodings are equal.  The reference's Pallas ``window_mult`` cannot run
on the CPU in useful time (``ba_tpu/ops/ladder.py:23-26``), so K3''s
plain version is held against its jnp ``scalar_mult``, the same group
element in another projective form: compared compressed."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import ed25519 as JE
from ba_tpu.crypto import scalar as JS
from ba_tpu_torch import convert
from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto import oracle, scalar, signed
from ba_tpu_torch.ops import ladder, treeadd

P, L = oracle.P, oracle.L


@pytest.fixture(scope="module")
def ref():
    return {
        "mul_mod_l": jax.jit(JS.mul_mod_l),
        "sum_mod_l": jax.jit(JS.sum_mod_l),
        "scalar_mult": jax.jit(JE.scalar_mult),
        "verify_rlc": jax.jit(JE.verify_rlc, static_argnames="pk_group"),
        "verify": jax.jit(JE.verify),
    }


def _le(v: int, n: int = 32) -> np.ndarray:
    return np.frombuffer(v.to_bytes(n, "little"), np.uint8)


def _int(row) -> int:
    return int.from_bytes(np.asarray(row, np.uint8).tobytes(), "little")


def _affine_enc(enc: np.ndarray) -> bytes:
    """A point uint8 [4, 32] (canonical X, Y, Z, T) -> its 32-byte
    compressed encoding, by Python integers."""
    x, y, z = (_int(enc[c]) for c in range(3))
    zi = pow(z, P - 2, P)
    return oracle.encode_point((x * zi % P, y * zi % P))


# -- mul_mod_l, sum_mod_l ---------------------------------------------------------


def test_mul_mod_l_matches_reference_and_integers(ref):
    rs = np.random.default_rng(21)
    a = rs.integers(0, 256, (64, 32), dtype=np.uint8)
    z = rs.integers(0, 256, (64, 16), dtype=np.uint8)
    a[0], a[1], a[2] = 0, 255, _le(L - 1)
    z[1] = z[2] = 255
    got = scalar.mul_mod_l(torch.tensor(a), torch.tensor(z)).numpy()
    assert np.array_equal(got, np.asarray(ref["mul_mod_l"](jnp.asarray(a), jnp.asarray(z))))
    for i in range(64):
        assert _int(got[i]) == _int(a[i]) * _int(z[i]) % L


@pytest.mark.parametrize("G", [1, 2, 64, 4097])
def test_sum_mod_l_matches_reference_and_integers(ref, G):
    v = np.random.default_rng(G).integers(0, 256, (3, G, 32), dtype=np.uint8)
    v[0, 0] = 255
    got = scalar.sum_mod_l(torch.tensor(v)).numpy()
    assert np.array_equal(got, np.asarray(ref["sum_mod_l"](jnp.asarray(v))))
    for i in range(3):
        assert _int(got[i]) == sum(_int(v[i, g]) for g in range(G)) % L


def test_sum_mod_l_above_default_headroom(ref):
    """G = 1.2M: the sum needs more than the two spare limbs a fixed
    settle gives (the reference's test of its G-sized headroom)."""
    G = 1_200_000
    lm1 = torch.from_numpy(_le(L - 1).copy()).expand(G, 32)
    got = scalar.sum_mod_l(lm1).numpy()
    assert _int(got) == G * (L - 1) % L
    want = ref["sum_mod_l"](jnp.broadcast_to(jnp.asarray(_le(L - 1)), (G, 32)))
    assert np.array_equal(got, np.asarray(want))


def test_sum_mod_l_refuses_int32_overflow():
    with pytest.raises(ValueError, match="overflows"):
        scalar.sum_bytes(torch.zeros((1, 2**31 // 255 + 1, 32), dtype=torch.uint8))


# -- batch_point_sum, plain_window_mult --------------------------------------------


def _base_multiples(ks) -> np.ndarray:
    """[k]B for each k as affine-extended 22-limb points: int32 [4, N, 22]."""
    rows = []
    for k in ks:
        x, y = oracle.scalarmult(oracle.BASE, k)
        rows.append([F._np_limbs(v) for v in (x, y, 1, x * y % P)])
    return np.ascontiguousarray(np.transpose(np.array(rows, np.int32), (1, 0, 2)))


@pytest.mark.parametrize("B", [1, 2, 3, 5, 8])
def test_batch_point_sum_matches_reference(B):
    pts = _base_multiples(range(3, 3 + 7 * B, 7))
    got = E.batch_point_sum(tuple(torch.tensor(c) for c in pts))
    want = JE.batch_point_sum(tuple(jnp.asarray(c) for c in pts))
    got_enc = E.encode_point(got)[0].numpy()
    want_enc = convert.point_from_limbs22(tuple(np.asarray(c) for c in want), "cpu")[0].numpy()
    k_total = sum(range(3, 3 + 7 * B, 7))
    assert _affine_enc(got_enc) == _affine_enc(want_enc) == \
        oracle.encode_point(oracle.scalarmult(oracle.BASE, k_total))


def _window_points(S: int) -> torch.Tensor:
    """The identity, B, [s]B from the plain K4 fold (Z != 1) and
    decompressed keys: uint8 [S, 4, 32]."""
    ends = torch.cat([E.encode_point(E.identity((1,))), E.encode_point(E.base_point((1,)))])
    s = torch.tensor(np.stack([_le(v) for v in (5, L - 2, 2**200 + 11)]))
    sb = treeadd.plain_fixed_base_fold(s, E.fixed_base_table("cpu"))
    keys = torch.tensor(np.stack([np.frombuffer(oracle.keypair(bytes([i]))[1], np.uint8)
                                  for i in range(S)]))
    return torch.cat([ends, sb, E.decompress(keys)[0]])[:S].contiguous()


def _affine(enc: np.ndarray) -> tuple:
    """A point uint8 [4, 32] -> affine (x, y) by Python integers."""
    x, y, z = (_int(enc[c]) for c in range(3))
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


@pytest.mark.parametrize("nbytes", [16, 32])
def test_plain_window_mult_matches_reference_scalar_mult(ref, nbytes):
    """K3''s plain version, the signed-window chain, against the
    reference's jitted scalar_mult and the oracle's integer arithmetic
    (compressed), on scalars whose recoding carries out of the top (a top
    nibble of 8 or 15, 0x88...8, all ones); its sum times 8 against the
    reference's products summed and doubled by the oracle."""
    S = 12
    pts = _window_points(S)
    top = 2 ** (8 * nbytes) - 1
    edges = [0, 1, 8, 15, 16, (L - 1) % (top + 1), top, 8 << (8 * nbytes - 4),
             int("8" * 2 * nbytes, 16), 15 << (8 * nbytes - 4)]
    rs = np.random.default_rng(nbytes)
    k = np.concatenate([np.stack([_le(v, nbytes) for v in edges]),
                        rs.integers(0, 256, (S - len(edges), nbytes), dtype=np.uint8)])
    got = ladder.plain_window_mult(pts, torch.tensor(k)).numpy()
    limbs = [np.asarray(c) for c in E.decode_point(pts)]
    bits = np.unpackbits(k, axis=1, bitorder="little").astype(np.int32)
    want = ref["scalar_mult"](tuple(jnp.asarray(c) for c in limbs), jnp.asarray(bits))
    want = convert.point_from_limbs22(tuple(np.asarray(c) for c in want), "cpu").numpy()
    assert [_affine_enc(g) for g in got] == [_affine_enc(w) for w in want]
    assert [_affine_enc(g) for g in got] == [
        oracle.encode_point(oracle.scalarmult(_affine(p), _int(kk)))
        for p, kk in zip(pts.numpy(), k)]
    empty = (torch.zeros((0, 4, 32), dtype=torch.uint8), torch.zeros((0, 32), dtype=torch.uint8))
    sets = ((pts, torch.tensor(k), *empty) if nbytes == 16 else
            (empty[0], empty[1][:, :16], pts, torch.tensor(k)))
    summed = ladder.plain_window_mult_sum8(*sets)[0].numpy()
    total = (0, 1)
    for w in want:
        total = oracle.edwards_add(total, _affine(w))
    assert _affine_enc(summed) == oracle.encode_point(oracle.scalarmult(total, 8))


def test_plain_window_mult_one_point_matches_reference_scalar_mult(ref):
    """Lanes that share one point (a warp's one table: signed 4-bit
    windows) against the reference's jitted scalar_mult and the oracle,
    compressed, on the edge scalars of the test above."""
    S = 12
    pts = _window_points(5)[4:5].repeat(S, 1, 1).contiguous()
    assert bool(ladder.warp_point_lanes(pts).all())
    top = 2**256 - 1
    edges = [0, 1, 8, 15, 16, L - 1, top, 8 << 252, int("8" * 64, 16), 15 << 252]
    rs = np.random.default_rng(5)
    k = np.concatenate([np.stack([_le(v) for v in edges]),
                        rs.integers(0, 256, (S - len(edges), 32), dtype=np.uint8)])
    got = ladder.plain_window_mult(pts, torch.tensor(k)).numpy()
    limbs = [np.asarray(c) for c in E.decode_point(pts)]
    bits = np.unpackbits(k, axis=1, bitorder="little").astype(np.int32)
    want = ref["scalar_mult"](tuple(jnp.asarray(c) for c in limbs), jnp.asarray(bits))
    want = convert.point_from_limbs22(tuple(np.asarray(c) for c in want), "cpu").numpy()
    assert [_affine_enc(g) for g in got] == [_affine_enc(w) for w in want]
    p = _affine(pts[0].numpy())
    assert [_affine_enc(g) for g in got] == [oracle.encode_point(oracle.scalarmult(p, _int(kk)))
                                             for kk in k]


def test_window_mult_zero_scalar_is_the_identity_on_any_point():
    """z = 0 on a lane whose encoding failed: the product is the identity
    whatever the point's limbs hold, so the lane adds nothing."""
    bad = torch.tensor(np.stack([_le(2), _le(P + 3)]))
    pts, ok = E.decompress(bad)
    assert not ok.any()
    out = ladder.plain_window_mult(pts, torch.zeros((2, 16), dtype=torch.uint8))
    assert [_affine_enc(o) for o in out.numpy()] == [oracle.encode_point((0, 1))] * 2


# -- verify_rlc ---------------------------------------------------------------------


def _rlc_lanes(B=4, n=4, seed=24):
    """The reference's RLC fixture: B commanders, n signed round-1 values
    each (``sign_received``), flattened group-major."""
    sks, pks = signed.commander_keys(B)
    received = np.random.default_rng(seed).integers(0, 2, (B, n))
    msgs, sigs = signed.sign_received(sks, pks, received)
    return (np.repeat(pks, n, axis=0), msgs.reshape(B * n, -1), sigs.reshape(B * n, 64))


def _both(ref, pk, msg, sig, z, pk_group):
    got_ok, got_enc = E.verify_rlc(*(torch.tensor(a) for a in (pk, msg, sig, z)),
                                   pk_group=pk_group)
    want_ok, want_enc = ref["verify_rlc"](*(jnp.asarray(a) for a in (pk, msg, sig, z)),
                                          pk_group=pk_group)
    assert bool(got_ok) == bool(want_ok)
    assert np.array_equal(got_enc.numpy(), np.asarray(want_enc))
    return bool(got_ok), got_enc.numpy()


def test_sign_received_matches_reference():
    sks, pks = signed.commander_keys(3)
    received = np.array([[0, 1], [1, 1], [0, 0]])
    corrupt = np.array([[False, True], [False, False], [False, False]])
    msgs, sigs = signed.sign_received(sks, pks, received, corrupt)
    from ba_tpu.crypto import signed as JSG

    want_m, want_s = JSG.sign_received(sks, pks, received, corrupt)
    assert np.array_equal(msgs, want_m) and np.array_equal(sigs, want_s)


@pytest.mark.parametrize("pk_group", [4, 1])
def test_verify_rlc_valid_batch_accepts(ref, pk_group):
    pk, msg, sig = _rlc_lanes()
    z = np.random.default_rng(1).integers(0, 256, (16, 16), dtype=np.uint8)
    ok, enc = _both(ref, pk, msg, sig, z, pk_group)
    assert ok and enc.all()


def test_verify_rlc_flipped_byte_rejects(ref):
    pk, msg, sig = _rlc_lanes()
    sig = sig.copy()
    sig[6, 40] ^= 0x01
    z = np.random.default_rng(2).integers(0, 256, (16, 16), dtype=np.uint8)
    ok, enc = _both(ref, pk, msg, sig, z, 4)
    assert not ok and enc.all()


def test_verify_rlc_out_of_range_s_is_flagged(ref):
    pk, msg, sig = _rlc_lanes()
    sig = sig.copy()
    sig[9, 32:] = 0xFF
    sig[3, 32:] = _le(int.from_bytes(sig[3, 32:].tobytes(), "little") + L)
    z = np.random.default_rng(3).integers(0, 256, (16, 16), dtype=np.uint8)
    ok, enc = _both(ref, pk, msg, sig, z, 4)
    assert not ok and not enc[9] and not enc[3] and enc.sum() == 14


def test_verify_rlc_bad_key_zeroes_its_group(ref):
    """A key that does not decompress fails every lane of its group's
    encodings, and the batch."""
    pk, msg, sig = _rlc_lanes()
    pk = pk.copy()
    pk[8:12] = _le(2)
    z = np.random.default_rng(4).integers(0, 256, (16, 16), dtype=np.uint8)
    ok, enc = _both(ref, pk, msg, sig, z, 4)
    assert not ok and not enc[8:12].any() and enc.sum() == 12


def _torsion_point():
    """A small-order point: the first curve point by y whose [L]Q is not
    the identity (``tests/test_crypto.py:489``)."""
    for y in range(2, 200):
        try:
            q = oracle.decode_point(int(y).to_bytes(32, "little"))
        except ValueError:
            continue
        x, yy = q
        if (-x * x + yy * yy - 1 - oracle.D * x * x * yy * yy) % P:
            continue
        cand = oracle.scalarmult(q, L)
        if cand != (0, 1):
            return cand
    raise AssertionError("no small-order point in the scan range")


def test_verify_rlc_cofactored_accepts_torsion_malleated_sig(ref):
    """Lane 1 offsets its own R by a small-order point and re-signs: the
    per-signature verify rejects it, the cofactored batch check accepts
    it, and the same lane with S + 1 rejects (a prime-order defect)."""
    sks, pks = signed.commander_keys(16, seed=7)
    msgs = [signed.order_message(i, i & 1) for i in range(16)]
    sigs = [oracle.sign(sk, pk.tobytes(), m) for sk, pk, m in zip(sks, pks, msgs)]
    h = hashlib.sha512(sks[1]).digest()
    a = oracle._clamp(h[:32])
    r = oracle._hint(h[32:] + msgs[1]) % L
    r_enc = oracle.encode_point(oracle.edwards_add(oracle.scalarmult(oracle.BASE, r),
                                                   _torsion_point()))
    s = (r + oracle._hint(r_enc + pks[1].tobytes() + msgs[1]) % L * a) % L
    sigs[1] = r_enc + s.to_bytes(32, "little")
    assert not oracle.verify(pks[1].tobytes(), msgs[1], sigs[1])
    pk = np.asarray(pks)
    msg = np.stack([np.frombuffer(m, np.uint8) for m in msgs])
    sig = np.stack([np.frombuffer(x, np.uint8) for x in sigs])
    per_sig = E.verify(*(torch.tensor(x) for x in (pk, msg, sig))).numpy()
    assert per_sig.tolist() == [True, False] + [True] * 14
    assert np.array_equal(per_sig, np.asarray(ref["verify"](
        *(jnp.asarray(x) for x in (pk, msg, sig)))))
    z = signed.fresh_rlc_coeffs(16)
    ok, enc = _both(ref, pk, msg, sig, z, 1)
    assert ok and enc.all()
    sig[1, 32:] = _le((s + 1) % L)
    ok, _ = _both(ref, pk, msg, sig, z, 1)
    assert not ok


def test_verify_rlc_rejects_bad_group():
    pk, msg, sig = (torch.tensor(a) for a in _rlc_lanes())
    with pytest.raises(ValueError, match="groups"):
        E.verify_rlc(pk, msg, sig, torch.zeros((16, 16), dtype=torch.uint8), pk_group=3)


# -- the "rlc" routes of signed.py -----------------------------------------------------


def test_fresh_rlc_coeffs_are_fresh():
    a, b = signed.fresh_rlc_coeffs(8), signed.fresh_rlc_coeffs(8)
    assert a.shape == (8, 16) and a.dtype == np.uint8 and not np.array_equal(a, b)


def _tables(B=4, n=4, seed=25):
    sks, pks = signed.commander_keys(B)
    received = np.random.default_rng(seed).integers(0, 2, (B, n))
    return (pks, *signed.sign_received(sks, pks, received))


def test_verify_received_rlc_matches_exact():
    pks, msgs, sigs = _tables()
    got = signed.verify_received(pks, msgs, sigs, device="cpu", verify="rlc")
    assert got.shape == (4, 4) and bool(got.all())
    bad = sigs.copy()
    bad[3, 0, 0] ^= 0xFF
    got = signed.verify_received(pks, msgs, bad, device="cpu", verify="rlc")
    want = signed.verify_received(pks, msgs, bad, device="cpu")
    assert torch.equal(got, want) and not got[3, 0] and int(got.sum()) == 15
    assert np.array_equal(want.numpy(), signed.verify_host_exact(pks, msgs, bad))


def test_verify_received_refuses_unknown_route():
    pks, msgs, sigs = _tables(1, 1)
    with pytest.raises(ValueError, match="verify"):
        signed.verify_received(pks, msgs, sigs, device="cpu", verify="batch")


def test_rlc_batch_ok_chunked_padding(monkeypatch):
    """A 20-lane call in chunks of 8 (whole groups of n = 4), its tail
    padded with one copy of the first group; a bad lane in the tail
    rejects."""
    pks, msgs, sigs = _tables(5, 4, 26)
    monkeypatch.setattr(signed, "VERIFY_CHUNK", 8)
    calls = []
    real = E.verify_rlc
    monkeypatch.setattr(E, "verify_rlc", lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    assert bool(signed.rlc_batch_ok(pks, msgs, sigs, device="cpu"))
    assert calls == [8, 8, 8]
    bad = sigs.copy()
    bad[4, 3, 40] ^= 0x01
    assert not bool(signed.rlc_batch_ok(pks, msgs, bad, device="cpu"))


@pytest.mark.parametrize("sign_device", [False, True])
def test_setup_rlc_route_matches_exact(sign_device):
    """The setup's "rlc" route: each chunk's batch verdict comes back in
    the one fetch; the tables and verdicts equal the exact route's."""
    B = 5
    out = signed.setup_signed_tables(B, seed=3, device="cpu", sign_device=sign_device,
                                     verify="rlc")
    want = signed.setup_signed_tables(B, seed=3, device="cpu", sign_device=sign_device)
    for got_part, want_part in zip(out[:4], want[:4]):
        assert np.array_equal(np.asarray(got_part), np.asarray(want_part))
    assert torch.equal(out[4], want[4]) and bool(out[4].all()) and out[4].shape == (B, 2)
    assert out[5]["verify"] == "rlc" and want[5]["verify"] == "exact"
    assert out[5]["chunks"] == (1 if sign_device else signed.SETUP_CHUNKS)


def test_setup_rlc_route_falls_back_on_a_bad_chunk(monkeypatch):
    """A chunk whose batch check fails gets the exact verdicts."""
    monkeypatch.setattr(signed, "rlc_batch_ok", lambda *a, **k: torch.tensor(False))
    sks, pks, msgs, sigs, ok, t = signed.setup_signed_tables(3, seed=4, device="cpu",
                                                             verify="rlc")
    assert t["verify"] == "rlc" and ok.shape == (3, 2) and bool(ok.all())
    assert np.array_equal(ok.numpy(), signed.verify_host_exact(pks, msgs, sigs))
