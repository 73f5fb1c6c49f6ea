"""The port's double-and-add scalar multiply and ``pow_planes`` on the CPU
against ``ba_tpu``: ``crypto/ed25519.scalar_mult`` / ``scalar_mult_base``
and ``ops/ladder.scalar_mult`` (K3''s CPU route, the plain ladder) against
the reference's jnp ``scalar_mult`` under ``jax.jit`` (its Pallas ladder
cannot run on the CPU in useful time, ``ba_tpu/ops/ladder.py:22-26``);
``ops/powchain.pow_planes`` (the CPU routes of K8', the p - 2 chain and
K8'') against the reference's ``pow_planes`` in interpret mode for small
exponents and against its eager ``pow_const`` and chain algebra for the
rest.  Tolerance zero: canonical limbs are equal."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import ed25519 as JE
from ba_tpu.crypto import field as JF
from ba_tpu.ops import ladder as jladder
from ba_tpu.ops import powchain as jpowchain
from ba_tpu_torch import ops
from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto import oracle
from ba_tpu_torch.ops import ladder, powchain, treeadd

P, L = oracle.P, oracle.L


@pytest.fixture(scope="module")
def ref():
    return {"scalar_mult": jax.jit(JE.scalar_mult),
            "scalar_mult_base": jax.jit(JE.scalar_mult_base)}


def _canon(limbs) -> np.ndarray:
    return np.asarray(F.canonical(torch.as_tensor(np.asarray(limbs))))


def _points(S: int) -> tuple:
    """S point limbs [S, 22] x 4: the identity, B, then [s]B from the plain
    K4 fold (Z != 1) for seeded scalars."""
    rs = np.random.default_rng(S)
    s = torch.tensor(rs.integers(0, 256, (S, 32), dtype=np.uint8))
    pts = torch.cat([E.encode_point(E.identity((1,))), E.encode_point(E.base_point((1,))),
                     treeadd.plain_fixed_base_fold(s, E.fixed_base_table("cpu"))])[:S]
    return E.decode_point(pts)


def _bits(S: int, nbits: int) -> np.ndarray:
    """Seeded 0/1 [S, nbits]: all zeros, all ones, a lone 1, then random."""
    bits = np.random.default_rng(nbits).integers(0, 2, (S, nbits)).astype(np.int32)
    bits[0], bits[1], bits[2] = 0, 1, 0
    bits[2, 0] = 1
    return bits


@pytest.mark.parametrize("nbits", [32, 512])
def test_scalar_mult_matches_reference(ref, nbits):
    """ed25519.scalar_mult and ladder.scalar_mult (the CPU routes) against
    the reference's jitted scalar_mult: canonical X, Y, Z and T equal."""
    S = 6
    pts, bits = _points(S), _bits(S, nbits)
    want = ref["scalar_mult"](tuple(jnp.asarray(c.numpy()) for c in pts), jnp.asarray(bits))
    got = E.scalar_mult(pts, torch.tensor(bits))
    for g, w in zip(got, want):
        assert np.array_equal(_canon(g), np.asarray(JF.canonical(w)))
    enc = ladder.scalar_mult(E.encode_point(pts), torch.tensor(bits))
    assert torch.equal(enc, E.encode_point(got))
    assert ops.ladder_scalar_mult is ladder.scalar_mult


def test_scalar_mult_base_matches_reference_and_oracle(ref):
    bits = _bits(4, 64)
    want = ref["scalar_mult_base"](jnp.asarray(bits))
    got = E.scalar_mult_base(torch.tensor(bits))
    for g, w in zip(got, want):
        assert np.array_equal(_canon(g), np.asarray(JF.canonical(w)))
    for row, enc in zip(bits, powchain.plain_compress(E.encode_point(got))):
        k = int("".join(str(b) for b in row[::-1]), 2)
        assert enc.numpy().tobytes() == oracle.encode_point(oracle.scalarmult(oracle.BASE, k))


def test_point_select_matches_reference():
    p, q = _points(4), E.identity((4,))
    mask = torch.tensor([True, False, False, True])
    want = JE.point_select(jnp.asarray(mask.numpy()), tuple(jnp.asarray(c.numpy()) for c in p),
                           tuple(jnp.asarray(c.expand(4, F.LIMBS).numpy()) for c in q))
    for g, w in zip(E.point_select(mask, p, q), want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pack_bits_matches_reference_layout():
    """K3'''s words are the reference's _pack_bits words, untiled."""
    bits = np.random.default_rng(3).integers(0, 2, (5, 96)).astype(np.int32)
    want = np.asarray(jladder._pack_bits(jnp.asarray(bits), jladder.TILE)).reshape(3, -1)[:, :5]
    assert np.array_equal(ladder.pack_bits(torch.tensor(bits)).numpy(), want)


def test_scalar_mult_rejects_bad_inputs():
    pts = torch.zeros((4, 4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts, torch.zeros((4, 33), dtype=torch.int32))
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts, torch.zeros((3, 32), dtype=torch.int32))
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts.to("meta"), torch.zeros((4, 32), dtype=torch.int32, device="meta"))


def _limbs(N: int, seed: int) -> np.ndarray:
    """Limbs in [-8000, 8000), as the reference's tests feed pow_planes,
    with 0, 1 and p - 1 in the first rows."""
    a = np.random.default_rng(seed).integers(-8000, 8000, (N, F.LIMBS)).astype(np.int32)
    for i, v in enumerate((0, 1, P - 1)):
        a[i] = F._np_limbs(v)
    return a


@pytest.mark.parametrize("e", [1, 2, 37])
def test_pow_planes_small_exponents_match_reference_interpret(e):
    a = _limbs(8, 5)
    want = jpowchain.pow_planes(jnp.asarray(a), e, interpret=True)
    got = powchain.pow_planes(torch.tensor(a), e)
    assert np.array_equal(_canon(got), np.asarray(JF.canonical(want)))


def _ref_sq_n(x, n):
    for _ in range(n):
        x = JF.square(x)
    return x


RANDOM_E = int.from_bytes(np.random.default_rng(7).bytes(32), "little") >> 1  # 255 bits


@pytest.mark.parametrize("e", [(P - 5) // 8, P - 2, 0, RANDOM_E],
                         ids=["sqrt", "inv", "zero", "random255"])
def test_pow_planes_matches_reference_algebra(e):
    """The chains against the reference's chain algebra on its eager field
    (``tests/test_ops.py:260-303``) and against pow_const; every exponent
    against Python's pow."""
    a = _limbs(6, 9)
    ja = JF.carry(jnp.asarray(a))
    want = JF.pow_const(ja, e)
    if e == (P - 5) // 8:
        want_chain = jpowchain.sqrt_chain(ja, JF.mul, _ref_sq_n)
    elif e == P - 2:
        want_chain = jpowchain.inv_chain(ja, JF.mul, _ref_sq_n)
    else:
        want_chain = want
    got = _canon(powchain.pow_planes(torch.tensor(a), e))
    assert np.array_equal(got, np.asarray(JF.canonical(want)))
    assert np.array_equal(got, np.asarray(JF.canonical(want_chain)))
    weights = [1 << (12 * i) for i in range(F.LIMBS)]
    for row, out in zip(a, got):
        v = sum(int(x) * w for x, w in zip(row, weights)) % P
        assert sum(int(x) * w for x, w in zip(out, weights)) == pow(v, e, P)


def test_pow_planes_routes_as_the_reference(monkeypatch):
    """(p - 5)/8 to K8', p - 2 to the inversion chain, any other exponent
    (its own neighbours included) to K8''."""
    seen = []
    for name in ("sqrt_chain", "inv_chain", "pow_exp"):
        real = getattr(powchain, name)
        monkeypatch.setattr(powchain, name,
                            lambda *args, _n=name, _f=real: seen.append(_n) or _f(*args))
    a = torch.tensor(_limbs(3, 2))
    for e in ((P - 5) // 8, P - 2, (P - 5) // 8 + 1, P - 3, 5):
        powchain.pow_planes(a, e)
    assert seen == ["sqrt_chain", "inv_chain", "pow_exp", "pow_exp", "pow_exp"]


def test_pow_wrappers_reject_bad_inputs():
    enc = torch.zeros((3, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        powchain.pow_exp(enc, -1)
    with pytest.raises(ValueError):
        powchain.sqrt_chain(enc[:, :31])
    with pytest.raises(ValueError):
        powchain.inv_chain(enc.to("meta"))
    with pytest.raises(ValueError):
        powchain.pow_planes(torch.zeros((3, 21), dtype=torch.int32), 3)


@pytest.mark.parametrize("ks,doublings,additions", [
    ([0], 0, 0), ([1], 0, 1), ([2**255], 255, 1), ([2**256 - 1], 255, 256),
    ([0, 1, 2**255, 2**256 - 1], 510, 258)], ids=["0", "1", "2^255", "ones", "batch"])
def test_k3pp_least_ops_hand_counts(ks, doublings, additions):
    """K3''s bound counts, per lane, q + q up to k's highest set bit and acc
    + q at its set bits (chip_smoke.k3pp_least_ops), on int and bool bits."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    want = doublings * chip_smoke.K3PP_DBL_OPS + additions * chip_smoke.K3PP_ADD_OPS
    bits = torch.tensor([[(k >> t) & 1 for t in range(256)] for k in ks], dtype=torch.int32)
    assert chip_smoke.k3pp_least_ops(bits) == want
    assert chip_smoke.k3pp_least_ops(bits.bool()) == want
