"""The port's plain field (``ba_tpu_torch/crypto/field.py``) and mod-L
reduction (``crypto/scalar.py``) against ``ba_tpu.crypto.field`` /
``ba_tpu.crypto.scalar`` and Python integers, tolerance zero.

The port keeps the reference's limbs and passes, so canonical forms are
compared limb for limb, and so are products of operands at the lazy
bounds of ``field.carry``'s contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import field as JF
from ba_tpu.crypto.scalar import reduce_mod_l as j_reduce_mod_l
from ba_tpu_torch import convert
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto import oracle
from ba_tpu_torch.crypto.scalar import reduce_mod_l

P = F.P_INT


def _value(limbs) -> int:
    return sum(int(x) << (12 * i) for i, x in enumerate(np.asarray(limbs).tolist()))


def _edge_limbs(seed: int, n: int = 64) -> np.ndarray:
    """The edge inputs of ``tests/test_ops.py``'s plane canonical test:
    lazy and negative limbs, 0, p - 1 and 2p - 2 as doubled limbs."""
    rs = np.random.default_rng(seed)
    a = rs.integers(-8000, 8000, (n, F.LIMBS)).astype(np.int32)
    a[0] = 0
    a[1] = JF._np_limbs(P - 1)
    a[2] = JF._np_limbs(P - 1) * 2
    a[3] = JF._np_limbs(P)
    a[4] = JF._np_limbs(2**255 - 1)
    return a


def _lazy_bound_limbs(seed: int, n: int = 32) -> np.ndarray:
    """Operands at the multiply-safe bounds: one lazy add or sub of two
    carried values, |limb 0| < 27652 and the other limbs below 8192."""
    rs = np.random.default_rng(seed)
    a = rs.integers(-8191, 8192, (n, F.LIMBS)).astype(np.int32)
    a[:, 0] = rs.integers(-27651, 27652, n)
    a[0] = 8191
    a[0, 0] = 27651
    a[1] = -8191
    a[1, 0] = -27651
    return a


@pytest.mark.parametrize("seed", [9, 10])
def test_canonical_matches_reference_limb_for_limb(seed):
    a = _edge_limbs(seed)
    got = F.canonical(torch.tensor(a)).numpy()
    assert np.array_equal(got, np.asarray(JF.canonical(jnp.asarray(a))))
    assert [_value(r) for r in got] == [_value(r) % P for r in a]
    assert got.min() >= 0 and got.max() < 4096


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mul_at_lazy_bounds_matches_reference(seed):
    a, b = _lazy_bound_limbs(seed), _lazy_bound_limbs(seed + 100)
    got = F.mul(torch.tensor(a), torch.tensor(b)).numpy()
    assert np.array_equal(got, np.asarray(JF.mul(jnp.asarray(a), jnp.asarray(b))))
    assert [_value(r) % P for r in got] == [_value(x) * _value(y) % P for x, y in zip(a, b)]
    sq = F.square(torch.tensor(a)).numpy()
    assert np.array_equal(sq, np.asarray(JF.square(jnp.asarray(a))))


def test_add_sub_carry_mul_small_eq_is_zero():
    a, b = _edge_limbs(4), _edge_limbs(5)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(F.add(ta, tb).numpy(), np.asarray(JF.add(ja, jb)))
    assert np.array_equal(F.sub(ta, tb).numpy(), np.asarray(JF.sub(ja, jb)))
    assert np.array_equal(F.carry(ta).numpy(), np.asarray(JF.carry(ja)))
    assert np.array_equal(F.mul_small(ta, 2).numpy(), np.asarray(JF.mul_small(ja, 2)))
    with pytest.raises(ValueError):
        F.mul_small(ta, 3001)
    shifted = ta + torch.tensor(JF._np_limbs(P))  # the same values, other limbs
    assert F.eq(ta, shifted).all()
    assert np.array_equal(F.eq(ta, tb).numpy(), np.asarray(JF.eq(ja, jb)))
    zeros = F.is_zero(ta).numpy()
    assert np.array_equal(zeros, np.asarray(JF.is_zero(ja)))
    assert zeros[0] and zeros[3] and not zeros[1]
    assert np.array_equal(F.constant(P + 5).numpy(), np.asarray(JF.constant(P + 5)))
    assert F.zeros((2, 3)).shape == (2, 3, 22)


def test_bytes_and_bits_match_reference():
    rs = np.random.default_rng(6)
    by = rs.integers(0, 256, (16, 32), dtype=np.uint8)
    by[0] = 0xFF
    got = F.from_bytes(torch.tensor(by)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(JF.from_bytes(jnp.asarray(by))))
    bits = F.bytes_to_bits(torch.tensor(by))
    assert np.array_equal(bits.numpy(), np.asarray(JF.bytes_to_bits(jnp.asarray(by))))
    assert np.array_equal(F.bits_to_bytes(bits).numpy(), by)
    lazy = _edge_limbs(7, 16)
    enc = F.to_bytes(torch.tensor(lazy)).numpy()
    assert np.array_equal(enc, np.asarray(JF.to_bytes(jnp.asarray(lazy))))
    assert [int.from_bytes(e.tobytes(), "little") for e in enc] == [_value(r) % P for r in lazy]


def test_pow_const_and_sqrt_chain():
    rs = np.random.default_rng(8)
    a = rs.integers(0, 4096, (4, F.LIMBS)).astype(np.int32)
    a[:, -1] &= 0xF  # below 2^256
    ta = torch.tensor(a)
    for e in (5, 2**20 + 3):
        assert np.array_equal(F.pow_const(ta, e).numpy(), np.asarray(JF.pow_const(jnp.asarray(a), e)))
    e = (P - 5) // 8
    got = F.canonical(F.sqrt_chain(ta)).numpy()
    want = np.asarray(JF.canonical(JF.pow_const(jnp.asarray(a), e)))
    assert np.array_equal(got, want)
    assert [_value(r) for r in got] == [pow(_value(r), e, P) for r in a]
    assert [_value(r) for r in F.canonical(F._tower_250(ta)).numpy()] == \
        [pow(_value(r), 2**250 - 1, P) for r in a]


def test_field_from_limbs22():
    a = _edge_limbs(11, 8)
    t = convert.field_from_limbs22(a, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), a)
    with pytest.raises(ValueError):
        convert.field_from_limbs22(a[:, :21], "cpu")


def test_reduce_mod_l_matches_reference_and_integers():
    L = oracle.L
    rs = np.random.default_rng(5)
    q = (2**512 - 1) // L
    vals = [0, 1, L - 1, L, L + 1, 2**252, 2**256, q * L - 1, q * L, 2**512 - 1]
    vals += [int.from_bytes(rs.bytes(64), "little") for _ in range(22)]
    by = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals])
    got = reduce_mod_l(torch.tensor(by)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(j_reduce_mod_l(jnp.asarray(by))))
    assert [int.from_bytes(g.tobytes(), "little") for g in got] == [v % L for v in vals]
