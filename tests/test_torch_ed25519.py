"""The port's Ed25519 verify path (``ba_tpu_torch/crypto/ed25519.py`` and
the plain versions of K7, K4 and K3) against ``ba_tpu.crypto.ed25519``
on the CPU (its jnp path), the pure-Python oracle and the RFC 8032
vectors: verdicts and canonical coordinates, tolerance zero.  Points
from the JAX package come across as canonical encodings
(``convert.point_from_limbs22``); points whose projective form depends
on the order of the additions are compared as group elements."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import ed25519 as JE
from ba_tpu.crypto import field as JF
from ba_tpu_torch import convert
from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto import oracle
from ba_tpu_torch.ops import decompress, ladder, modl, powchain, sha512_kernel, treeadd

P, L = oracle.P, oracle.L
CUH = pathlib.Path(__file__).resolve().parents[1] / "ba_tpu_torch/ops/csrc/ed25519_field.cuh"

RFC8032_VECTORS = [
    # (secret key, public key, message, signature): RFC 8032 section 7.1
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
]


def _le(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _rows(rows) -> np.ndarray:
    return np.stack([np.frombuffer(bytes(r), np.uint8) for r in rows])


def _int(enc: np.ndarray) -> int:
    return int.from_bytes(np.asarray(enc, np.uint8).tobytes(), "little")


def _affine(point_enc: np.ndarray) -> tuple[int, int]:
    x, y, z = (_int(point_enc[c]) for c in range(3))
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


@pytest.fixture(scope="module")
def cases():
    """16 lanes of 16-byte messages: valid signatures beside every
    rejection path of ``tests/test_crypto.py``: a corrupted R, S, message
    or key; R's y >= p; a non-square y as the key; x = 0 with sign 1 as
    the key (with the forgery it would admit); S >= L."""
    pks, msgs, sigs = [], [], []
    for i in range(16):
        sk, pk = oracle.keypair(bytes([70 + i]))
        msg = bytes([i]) * 16
        pks.append(pk), msgs.append(msg), sigs.append(bytearray(oracle.sign(sk, pk, msg)))
    sigs[6][0] ^= 1                                  # R
    sigs[7][40] ^= 1                                 # S
    msgs[8] = bytes([0xFF]) + msgs[8][1:]            # message
    pks[9] = pks[10]                                 # key
    sigs[10][:32] = _le(P)                           # R's y = p
    pks[11] = _le(2)                                 # y = 2: x^2 has no root
    pks[12] = bytes([1] + [0] * 30 + [0x80])         # x = 0 with sign 1
    r = oracle.encode_point(oracle.scalarmult(oracle.BASE, 5))
    sigs[12] = bytearray(r + (5).to_bytes(32, "little"))
    s = int.from_bytes(sigs[13][32:], "little")      # S + L: the same [S]B
    sigs[13][32:] = (s + L).to_bytes(32, "little")
    pks[14] = _le(P + 3)                             # the key's y >= p
    want = [oracle.verify(pk, m, bytes(sg)) for pk, m, sg in zip(pks, msgs, sigs)]
    return _rows(pks), _rows(msgs), _rows(sigs), want


def test_cases_cover_accepts_and_rejects(cases):
    assert cases[3] == [True] * 6 + [False] * 9 + [True]


def test_verify_matches_reference_and_oracle(cases):
    pk, msg, sig, want = cases
    got = E.verify(torch.tensor(pk), torch.tensor(msg), torch.tensor(sig))
    assert got.dtype == torch.bool and got.tolist() == want
    ref = np.asarray(jax.jit(JE.verify)(jnp.asarray(pk), jnp.asarray(msg), jnp.asarray(sig)))
    assert got.tolist() == ref.tolist()


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032_VECTORS)
def test_verify_rfc8032_vectors(sk, pk, msg, sig):
    m = bytes.fromhex(msg)
    t = lambda b: torch.tensor(np.frombuffer(b, np.uint8)[None].copy())  # noqa: E731
    pk_t, sig_t = t(bytes.fromhex(pk)), t(bytes.fromhex(sig))
    msg_t = torch.tensor(np.frombuffer(m, np.uint8).reshape(1, len(m)).copy())
    assert E.verify(pk_t, msg_t, sig_t).tolist() == [True]
    assert E.verify(pk_t, t(m + b"x"), sig_t).tolist() == [False]


def _encodings(pk, sig) -> np.ndarray:
    edges = [_le(v) for v in (0, 1, 2, P - 1, P, P + 1, 2 * P - 2, 2**256 - 1)]
    edges.append(bytes([1] + [0] * 30 + [0x80]))
    return np.concatenate([_rows(edges), pk[:4], sig[:4, :32]])


def test_decompress_plain_matches_reference(cases):
    pk, _, sig, _ = cases
    enc = _encodings(pk, sig)
    pts, ok = E.decompress(torch.tensor(enc))
    ref_pts, ref_ok = jax.jit(JE.decompress)(jnp.asarray(enc))
    assert ok.tolist() == np.asarray(ref_ok).tolist()
    ref = convert.point_from_limbs22(tuple(np.asarray(c) for c in ref_pts), "cpu")
    assert torch.equal(pts, ref)  # every lane, the invalid ones too
    assert ok[3] and not ok[4] and not ok[8] and ok[-8:].all()
    assert torch.equal(pts, decompress.plain_decompress(torch.tensor(enc))[0])


def _scalars(n_random: int) -> np.ndarray:
    rs = np.random.default_rng(4)
    vals = [0, 1, 15, 16, L - 1]
    vals += [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n_random)]
    return _rows(_le(v) for v in vals)


FIXED_BASE_EDGES = (8, L, 2**256 - 1, int("8" * 64, 16), (8 << 252) | 5)  # top nibble >= 8


def test_fixed_base_plain_matches_reference_and_oracle():
    s = np.concatenate([_scalars(5), _rows(_le(v) for v in FIXED_BASE_EDGES)])
    got = E.fixed_base_mult(torch.tensor(s))
    ref = convert.point_from_limbs22(
        tuple(np.asarray(c) for c in jax.jit(JE.fixed_base_mult)(jnp.asarray(s))), "cpu")
    assert E.point_eq(E.decode_point(got), E.decode_point(ref)).all()
    for i in range(len(s)):
        assert _affine(got[i].numpy()) == oracle.scalarmult(oracle.BASE, _int(s[i]))
    assert torch.equal(got, treeadd.plain_fixed_base_fold(torch.tensor(s), E.fixed_base_table("cpu")))


def test_window_verify_plain_matches_reference_composition(cases):
    """K3's plain version against point_eq(left, point_add(R, scalar_mult(A, h)))
    of the JAX package: left is R + [h]A itself in half the lanes."""
    pk, _, sig, _ = cases
    n = 8
    enc = np.concatenate([pk[:n], sig[:n, :32]])
    pts, _ = E.decompress(torch.tensor(enc))
    ref_pts, _ = jax.jit(JE.decompress)(jnp.asarray(enc))
    a_j = tuple(c[:n] for c in ref_pts)
    r_j = tuple(c[n:] for c in ref_pts)
    h = _scalars(3)  # 0, 1, 15, 16, L - 1 and three random
    h_bits = JF.bytes_to_bits(jnp.asarray(h))
    right_j = jax.jit(lambda a, r, b: JE.point_add(r, JE.scalar_mult(a, b)))(a_j, r_j, h_bits)
    other_j = jax.jit(JE.fixed_base_mult)(jnp.asarray(_scalars(3)[::-1].copy()))
    take = np.arange(n) % 2 == 0
    left_j = tuple(jnp.where(jnp.asarray(take)[:, None], x, y) for x, y in zip(right_j, other_j))
    want = np.asarray(jax.jit(JE.point_eq)(left_j, right_j))
    left = convert.point_from_limbs22(tuple(np.asarray(c) for c in left_j), "cpu")
    got = ladder.window_verify(pts[:n], torch.tensor(h), pts[n:], left)
    assert got.tolist() == want.tolist()
    assert want[take].all() and not want[~take].any()


def test_base_table_matches_reference():
    """The window table is the reference's; K4's table holds its entries
    j = 1..8 (and [j 2^256]B in row 64) in the cached form, as the
    kernels' canonical limbs."""
    table = E._base_table()
    assert np.array_equal(table, JE._base_table())
    fixed = E._fixed_base_table()
    assert fixed.shape == (65, 8, 32) and not fixed[..., 30:].any()
    weights = [1 << ((51 * i + 1) // 2) for i in range(10)]
    rs = np.random.default_rng(9)
    for w, j in [(0, 0), (63, 7), (64, 0), (64, 7)] + [tuple(rs.integers(0, (64, 8)))
                                                        for _ in range(8)]:
        w, j = int(w), int(j)
        x, y = oracle.scalarmult(oracle.BASE, (j + 1) << (4 * w))
        got = [sum(int(v) * c for v, c in zip(fixed[w, j, 10 * k:10 * k + 10], weights))
               for k in range(3)]
        assert got == [(y - x) % P, (y + x) % P, 2 * oracle.D * x * y % P]
        limbs = fixed[w, j, :30].reshape(3, 10)
        assert (limbs >= 0).all() and (limbs < [1 << (26 - (i & 1)) for i in range(10)]).all()
    assert torch.equal(E.fixed_base_table("cpu"), torch.tensor(fixed))


def _points(n: int):
    """n points of the group with canonical limbs, and their affine values."""
    affine = [oracle.scalarmult(oracle.BASE, 1000 + 77 * i) for i in range(n)]
    coords = [[x, y, 1, x * y % P] for x, y in affine]
    limbs = tuple(np.stack([JF._np_limbs(c[k]) for c in coords]) for k in range(4))
    return limbs, affine


def test_point_formulas_match_reference():
    (p_l, p_aff), (q_l, q_aff) = _points(6), _points(12)
    q_l = tuple(c[6:] for c in q_l)
    q_aff = q_aff[6:]
    tp = tuple(torch.tensor(c) for c in p_l)
    tq = tuple(torch.tensor(c) for c in q_l)
    s = E.point_add(tp, tq)
    ref = JE.point_add(tuple(jnp.asarray(c) for c in p_l), tuple(jnp.asarray(c) for c in q_l))
    for got, want in zip(s, ref):
        assert np.array_equal(got.numpy(), np.asarray(want))  # the same limbs
    enc = E.encode_point(s).numpy()
    assert [_affine(e) for e in enc] == [oracle.edwards_add(a, b) for a, b in zip(p_aff, q_aff)]
    d = E.point_dbl(tp)
    assert E.point_eq(d, E.point_add(tp, tp)).all()
    assert [_affine(e) for e in E.encode_point(d).numpy()] == \
        [oracle.edwards_add(a, a) for a in p_aff]
    assert not E.point_dbl(tp, with_t=False)[3].any()
    assert E.point_eq(tp, tp).all() and not E.point_eq(tp, tq).any()
    assert E.point_eq(E.point_add(tp, E.identity((6,))), tp).all()
    assert E.point_eq(E.base_point((1,)), E.decode_point(E.encode_point(E.base_point((1,))))).all()


def test_point_from_limbs22_round_trip():
    limbs, affine = _points(4)
    lazy = tuple(c + JF._np_limbs(P) for c in limbs)  # other limbs, the same values
    enc = convert.point_from_limbs22(lazy, "cpu")
    assert enc.dtype == torch.uint8 and enc.shape == (4, 4, 32)
    assert [_affine(e) for e in enc.numpy()] == affine
    assert torch.equal(E.encode_point(E.decode_point(enc)), enc)


def _cuh_value(name: str) -> int:
    body = re.search(name + r"\[10\] = \{(.*?)\};", CUH.read_text(), re.S).group(1)
    limbs = [int(x) for x in body.replace("\n", " ").split(",")]
    return sum(v << ((51 * i + 1) // 2) for i, v in enumerate(limbs)) % P


def test_point_add_cached_matches_point_add():
    """The cached-form addition of K4's entries: the values of point_add on
    the extended entry, for each sign of the digit."""
    (p_l, _), (q_l, q_aff) = _points(6), _points(6)
    tp = E.point_dbl(tuple(torch.tensor(c) for c in p_l))  # Z != 1
    x, y = (torch.tensor(q_l[k]) for k in (0, 1))
    txy = F.mul(x, y)
    two_d = F.constant(2 * oracle.D, "cpu")
    cached = (F.sub(y, x), F.add(y, x), F.mul(txy, two_d))
    want = E.point_add(tp, tuple(torch.tensor(c) for c in q_l))
    assert E.point_eq(E.point_add_cached(tp, cached), want).all()
    neg = (cached[1], cached[0], F.sub(F.zeros((6,)), cached[2]))
    back = E.point_add_cached(E.point_add_cached(tp, cached), neg)
    assert E.point_eq(back, tp).all()


def test_kernel_header_constants():
    assert _cuh_value("FE_D_LIMBS") == oracle.D
    assert _cuh_value("FE_D2_LIMBS") == 2 * oracle.D % P
    assert _cuh_value("FE_SQRTM1_LIMBS") == oracle.SQRT_M1


def test_wrappers_refuse_devices_they_do_not_run_on():
    meta = torch.zeros((2, 32), dtype=torch.uint8, device="meta")
    pts = torch.zeros((2, 4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        decompress.decompress(meta)
    with pytest.raises(ValueError):
        treeadd.fixed_base_fold(meta, E.fixed_base_table("cpu").to("meta"))
    with pytest.raises(ValueError):
        ladder.window_verify(pts, meta, pts, pts)
    with pytest.raises(ValueError):
        decompress.decompress(torch.zeros((2, 31), dtype=torch.uint8))
    words = torch.zeros((2, 1, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        sha512_kernel.sha512_blocks(words, words, 1)
    with pytest.raises(ValueError):
        modl.reduce_mod_l_planes(torch.zeros((2, 64), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        powchain.compress(pts)
    with pytest.raises(ValueError):
        modl.reduce_mod_l_planes(torch.zeros((2, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        powchain.compress(torch.zeros((2, 3, 32), dtype=torch.uint8))
