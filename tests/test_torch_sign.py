"""The port's Ed25519 signing path on the CPU (``crypto/field.inv``,
``crypto/scalar.muladd_bytes``, the plain versions of K5', K6 and K8,
``crypto/ed25519.compress`` / ``sign`` and the device-sign setup) against
``ba_tpu`` on its jnp path under ``jax.jit``, Python integers, hashlib and
the pure-Python oracle.  Tolerance zero: bytes, and field elements as
canonical values.  Each jitted reference compiles once per module."""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import ed25519 as JE
from ba_tpu.crypto import field as JF
from ba_tpu.crypto import scalar as JS
from ba_tpu.crypto import sha512 as jsha
from ba_tpu.ops import powchain as jpowchain
from ba_tpu_torch import convert
from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto import oracle, scalar, sha512, signed
from ba_tpu_torch.ops import modl, powchain, sha512_kernel

P, L = oracle.P, oracle.L


def _le(v: int, n: int = 32) -> np.ndarray:
    return np.frombuffer(v.to_bytes(n, "little"), np.uint8)


def _int(row) -> int:
    return int.from_bytes(np.asarray(row, np.uint8).tobytes(), "little")


@pytest.fixture(scope="module")
def jitted():
    sq_n = lambda x, n: jax.lax.fori_loop(0, n, lambda _, v: JF.mul(v, v), x)  # noqa: E731
    return {
        "inv": jax.jit(JF.inv),
        "inv_chain": jax.jit(functools.partial(jpowchain.inv_chain, mul=JF.mul, sq_n=sq_n)),
        "canonical": jax.jit(JF.canonical),
        "compress": jax.jit(JE.compress),
        "fixed_base": jax.jit(JE.fixed_base_mult),
        "sign": jax.jit(JE.sign),
    }


def test_inv_matches_reference_on_canonical_values(jitted):
    rs = np.random.default_rng(1)
    vals = [0, 1, 2, P - 1, 19, 2**255 - 20] + [int(rs.integers(1, 2**62)) ** 4 % P
                                                 for _ in range(6)]
    a = np.stack([JF._np_limbs(v) for v in vals])
    got = F.canonical(F.inv(torch.tensor(a))).numpy()
    assert np.array_equal(got, F.canonical(F.inv_chain(torch.tensor(a))).numpy())
    for name in ("inv", "inv_chain"):
        want = np.asarray(jitted["canonical"](jitted[name](jnp.asarray(a))))
        assert np.array_equal(got, want), name
    for v, row in zip(vals, got):
        assert sum(int(x) << (12 * i) for i, x in enumerate(row)) == pow(v, P - 2, P)


def _muladd_rows():
    """``tests/test_crypto.py``'s edge rows: zeros, all-0xFF, an L - 1
    pair; then random bytes."""
    rs = np.random.default_rng(23)
    k, a, r = (rs.integers(0, 256, (8, 32)).astype(np.uint8) for _ in range(3))
    k[0] = a[0] = r[0] = 0
    k[1] = a[1] = r[1] = 255
    k[2] = a[2] = _le(L - 1)
    return k, a, r


def test_muladd_bytes_matches_reference_and_integers():
    k, a, r = _muladd_rows()
    got = scalar.muladd_bytes(torch.tensor(k), torch.tensor(a), torch.tensor(r)).numpy()
    want = np.asarray(jax.jit(JS.muladd_bytes)(jnp.asarray(k), jnp.asarray(a), jnp.asarray(r)))
    assert got.shape == (8, 64) and np.array_equal(got, want)
    for i in range(8):
        assert _int(got[i]) == _int(k[i]) * _int(a[i]) + _int(r[i])


def test_modl_plain_matches_reference_and_integers():
    """K6's plain version on 0, all-0xFF, L - 1, L, 2L, muladd_bytes' worst
    case and random bytes."""
    rows = [_le(v, 64) for v in (0, 2**512 - 1, L - 1, L, 2 * L, (2**256 - 1) * 2**256)]
    rows += list(np.random.default_rng(2).integers(0, 256, (6, 64), dtype=np.uint8))
    h = np.stack(rows)
    before = modl.reduce_mod_l_planes.launches
    got = modl.reduce_mod_l_planes(torch.tensor(h)).numpy()
    assert modl.reduce_mod_l_planes.launches == before  # the CPU runs the plain version
    assert np.array_equal(got, np.asarray(jax.jit(JS.reduce_mod_l)(jnp.asarray(h))))
    assert [_int(g) for g in got] == [_int(x) % L for x in h]


@pytest.mark.parametrize("nbytes", [0, 32, 112, 300])
def test_sha512_blocks_plain_matches_hashlib_and_reference(nbytes):
    msg = np.random.default_rng(nbytes).integers(0, 256, (3, nbytes), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg))
    before = sha512_kernel.sha512_blocks.launches
    got = sha512_kernel.sha512_blocks(wh, wl, nb).numpy()
    assert sha512_kernel.sha512_blocks.launches == before
    assert np.array_equal(got, sha512.sha512(torch.tensor(msg)).numpy())
    assert [g.tobytes() for g in got] == [hashlib.sha512(m.tobytes()).digest() for m in msg]
    assert np.array_equal(got, np.asarray(jsha.sha512(jnp.asarray(msg))))


def test_compress_matches_reference_and_oracle(jitted):
    """Points with Z != 1 from the reference's fixed-base fold, the
    identity and B."""
    s = np.stack([_le(v) for v in (0, 1, 2, 15, 16, L - 1)]
                 + list(np.random.default_rng(3).integers(0, 256, (4, 32), dtype=np.uint8)))
    pt = jitted["fixed_base"](jnp.asarray(s))
    assert not (np.asarray(JF.canonical(pt[2])) == JF._np_limbs(1)).all(axis=1).all()
    enc = convert.point_from_limbs22(tuple(np.asarray(c) for c in pt), "cpu")
    enc = torch.cat([enc, E.encode_point(E.identity((1,))), E.encode_point(E.base_point((1,)))])
    got = E.compress(enc).numpy()
    assert np.array_equal(got, powchain.plain_compress(enc).numpy())
    assert np.array_equal(got[:len(s)], np.asarray(jitted["compress"](pt)))
    want = [oracle.encode_point(oracle.scalarmult(oracle.BASE, _int(v))) for v in s]
    want += [oracle.encode_point((0, 1)), oracle.encode_point(oracle.BASE)]
    assert [g.tobytes() for g in got] == want


def test_sign_matches_reference_and_oracle(jitted):
    """B = 8 with the all-zero secret key, as ``tests/test_crypto.py``."""
    B = 8
    sks = [oracle.secret_from_seed(f"signdev:{i}".encode()) for i in range(B)]
    sks[0] = b"\0" * 32
    pks = [oracle.publickey(sk) for sk in sks]
    msgs = [signed.order_message(i, i & 1) for i in range(B)]
    rows = lambda xs: np.stack([np.frombuffer(x, np.uint8) for x in xs])  # noqa: E731
    sk, pk, msg = rows(sks), rows(pks), rows(msgs)
    got = E.sign(torch.tensor(sk), torch.tensor(pk), torch.tensor(msg)).numpy()
    assert [g.tobytes() for g in got] == [oracle.sign(*t) for t in zip(sks, pks, msgs)]
    want = np.asarray(jitted["sign"](jnp.asarray(sk), jnp.asarray(pk), jnp.asarray(msg)))
    assert np.array_equal(got, want)
    assert np.array_equal(E.clamp_scalar(torch.tensor(sk)).numpy(),
                          np.asarray(JE.clamp_scalar(jnp.asarray(sk))))


def test_setup_signs_on_device_route_in_one_chunk():
    """``sign_device=True`` on the CPU runs the plain versions: the tables
    are byte-equal to the host-signed ones, in one chunk."""
    dev_route = signed.setup_signed_tables(8, seed=4, device="cpu", sign_device=True)
    host_route = signed.setup_signed_tables(8, seed=4, device="cpu")
    for got, want in zip(dev_route[1:4], host_route[1:4]):
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert dev_route[0] == host_route[0]
    assert torch.equal(dev_route[4], host_route[4]) and bool(dev_route[4].all())
    t = dev_route[5]
    assert t["chunks"] == signed.DEVICE_SIGN_CHUNKS == 1 and t["device_sign"] is True
    assert t["verify_route"] == "plain" and host_route[5]["device_sign"] is False
    msgs, sigs = signed.sign_value_tables_device(dev_route[0][:3], dev_route[1][:3],
                                                 base=5, device="cpu")
    want_m, want_s = signed.sign_value_tables(dev_route[0][:3], dev_route[1][:3], base=5)
    assert np.array_equal(msgs, want_m) and np.array_equal(sigs.numpy(), want_s)
