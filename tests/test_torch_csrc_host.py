"""The Ed25519 kernels' per-lane arithmetic (``ba_tpu_torch/ops/csrc``),
compiled for the host with g++ through ``tests/torch_csrc_host.cpp``,
against their plain torch versions: K7, K5, K5', K6, K4, K8, K3, K3'
(the window accumulator K3 shares, and its fold), K3'' (the
double-and-add ladder), pow_planes' K8', p - 2 chain and K8'', the
field-multiply probe P and K9 (its tile kernel and its warp kernel,
replayed tile by tile and lane by lane), bit-equal; K1's word-batched coin counts and
round-1 coins (``coins.cuh``) against ``rng.coin_bits`` of the same key,
and K2's packed relay word (``sweep_relay.cuh``) against the plain
version's separate counts.

The card runs the same functions inside the kernels; this catches an
arithmetic fault in a CUDA source on the CPU.  Launch code, warp shuffles
and memory layout are the card's to test (``tests/test_torch_kernel.py``,
``chip_smoke.py``).
"""

import ctypes
import hashlib
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import oracle, scalar, sha512
from ba_tpu_torch.ops import (decompress, fieldmul_probe, ladder, majority, modl, powchain,
                              sha512_kernel, treeadd)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "ba_tpu_torch" / "ops" / "csrc"
P, L = oracle.P, oracle.L


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out = tmp_path_factory.mktemp("csrc") / "host.so"
    proc = subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-I", str(CSRC), "-x", "c++",
         str(ROOT / "tests" / "torch_csrc_host.cpp"), "-o", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for name, n_ptr in (("host_decompress", 3), ("host_window_verify", 5)):
        getattr(lib, name).argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr
    for name in ("host_sha512_modl", "host_sha512"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    for name in ("host_modl", "host_compress", "host_sqrt_chain", "host_inv_chain"):
        getattr(lib, name).argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.host_window_mult.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.host_recode.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.host_window_mult_sum8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2) * 2 + \
        [ctypes.c_void_p]
    lib.host_scalar_mult.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.host_ge_add_self.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.host_pow.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.host_fieldmul_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.host_fe_sq.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.host_fixed_base.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.host_coin_counts.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32] + \
        [ctypes.c_void_p] * 3
    lib.host_round1_coins.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32] + \
        [ctypes.c_void_p] * 2
    lib.host_relay.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                                             ctypes.c_void_p]
    lib.host_majority.argtypes = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_longlong] + [ctypes.c_void_p] * 4)
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _le(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), np.uint8)


def _encodings(rs, n_random: int) -> np.ndarray:
    """Edge encodings, valid points and random bytes: uint8 [N, 32]."""
    rows = [_le(v) for v in (0, 1, 2, P - 1, P, P + 1, 2 * P - 2, 2**255 - 1, 2**256 - 1)]
    rows += [_le(v | (1 << 255)) for v in (0, 1, P - 1)]  # sign bit set, x = 0 at y = 1
    for i in range(6):
        rows.append(np.frombuffer(oracle.keypair(bytes([i]))[1], np.uint8))
    rows += list(rs.integers(0, 256, (n_random, 32), dtype=np.uint8))
    return np.ascontiguousarray(np.stack(rows))


def test_decompress_lane_matches_plain(host):
    enc = _encodings(np.random.default_rng(1), 10)
    pts = np.zeros((len(enc), 4, 32), np.uint8)
    ok = np.zeros(len(enc), np.uint8)
    host.host_decompress(len(enc), _ptr(enc), _ptr(pts), _ptr(ok))
    want_pts, want_ok = decompress.plain_decompress(torch.tensor(enc))
    assert np.array_equal(ok.astype(bool), want_ok.numpy())
    assert np.array_equal(pts, want_pts.numpy())
    # the oracle's keys are valid; y = p - 1 is (0, -1), y = p is out of range
    assert ok[-16:-10].all() and ok[3] and not ok[4]


@pytest.mark.parametrize("nbytes", [0, 1, 80, 111, 112, 200, 239, 240, 300])
def test_sha512_modl_lane_matches_plain_and_hashlib(host, nbytes):
    rs = np.random.default_rng(nbytes)
    msg = rs.integers(0, 256, (5, nbytes), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg))
    out = np.zeros((5, 32), np.uint8)
    host.host_sha512_modl(5, nb, _ptr(wh.numpy()), _ptr(wl.numpy()), _ptr(out))
    want = sha512_kernel.plain_sha512_blocks_mod_l(wh, wl, nb).numpy()
    assert np.array_equal(out, want)
    for i in range(5):
        digest = int.from_bytes(hashlib.sha512(msg[i].tobytes()).digest(), "little")
        assert int.from_bytes(out[i].tobytes(), "little") == digest % L


@pytest.mark.parametrize("nbytes", [0, 1, 32, 111, 112, 127, 128, 300])
def test_sha512_lane_matches_plain_and_hashlib(host, nbytes):
    msg = np.random.default_rng(nbytes + 7).integers(0, 256, (5, nbytes), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg))
    out = np.zeros((5, 64), np.uint8)
    host.host_sha512(5, nb, _ptr(wh.numpy()), _ptr(wl.numpy()), _ptr(out))
    assert np.array_equal(out, sha512_kernel.plain_sha512_blocks(wh, wl, nb).numpy())
    assert [o.tobytes() for o in out] == [hashlib.sha512(m.tobytes()).digest() for m in msg]


def _rows(vals) -> list:
    return [np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals]


def _quotient_gap(x: int) -> int:
    """floor(x / L) less K6's quotient estimate (``csrc/modl.cuh``): q =
    x >> 252, less the products q_i M_j with i + j >= 7 over 2^260 (M =
    2^260 - floor(2^512 / L)), less 2."""
    M = 2**260 - 2**512 // L
    q = x >> 252
    qw = [(q >> (32 * i)) & 0xFFFFFFFF for i in range(9)]
    mw = [(M >> (32 * j)) & 0xFFFFFFFF for j in range(5)]
    kept = sum(qw[i] * mw[j] << (32 * (i + j)) for i in range(9) for j in range(5) if i + j >= 7)
    return x // L - (q - (kept >> 260) - 2)


def modl_inputs(rs, case: str) -> np.ndarray:
    """K6's inputs by case: ``edges`` 0, all-0xFF, L - 1, L, 2L, the largest
    value of ``muladd_bytes`` (k = a = r = 2^256 - 1: low half 0, high half
    all ones, where the word form's quotient estimate is largest); for the
    word form ``shifted`` 2^256 m for small m, ``multiples`` kL and kL +- 1
    for k from 1 to floor(2^512 / L), ``word_ones`` all ones in one word
    and in all but one; ``quotient_edges`` random values where the quotient
    estimate is exact (gap 0, ~1 in 1 200: one less subtracted would
    overshoot) or 3 below (r nearest 4L); ``random`` 200 rows from the
    seed."""
    if case == "edges":
        ff = torch.full((1, 32), 255, dtype=torch.uint8)
        rows = _rows((0, 2**512 - 1, L - 1, L, 2 * L))
        rows.append(scalar.muladd_bytes(ff, ff, ff)[0].numpy())
    elif case == "shifted":
        rows = _rows(m << 256 for m in (1, 2, 3, 15, 16, 17, 255, 2**32 - 1, 2**64 + 1))
    elif case == "multiples":
        top = (2**512 - 1) // L
        ks = [1, 2, 3, 4, 15, 16, 2**128, 2**256 // L, top - 1, top]
        ks += [int(k) for k in rs.integers(1, 2**62, 8)] + [top // int(d) for d in range(2, 10)]
        rows = _rows(k * L + e for k in ks for e in (-1, 0, 1) if k * L + e < 2**512)
    elif case == "word_ones":
        ones = [0xFFFFFFFF << (32 * i) for i in range(16)]
        rows = _rows(ones + [(2**512 - 1) ^ v for v in ones])
    elif case == "quotient_edges":
        found = {0: [], 3: []}
        while min(len(v) for v in found.values()) < 4:
            x = int.from_bytes(rs.bytes(64), "little")
            gap = _quotient_gap(x)
            assert 0 <= gap <= 3
            if gap in found:
                found[gap].append(x)
        rows = _rows(found[0][:4] + found[3][:4])
    else:
        rows = list(rs.integers(0, 256, (200, 64), dtype=np.uint8))
    return np.ascontiguousarray(np.stack(rows))


@pytest.mark.parametrize("case", ["edges", "shifted", "multiples", "word_ones", "quotient_edges",
                                  "random"])
def test_modl_lane_matches_plain_and_integers(host, case):
    h = modl_inputs(np.random.default_rng(5), case)
    out = np.zeros((len(h), 32), np.uint8)
    host.host_modl(len(h), _ptr(h), _ptr(out))
    assert np.array_equal(out, modl.plain_reduce_mod_l(torch.tensor(h)).numpy())
    for row, got in zip(h, out):
        assert int.from_bytes(got.tobytes(), "little") == \
            int.from_bytes(row.tobytes(), "little") % L


def test_compress_lane_matches_plain_and_oracle(host):
    """The identity, B, and [s]B from the plain K4 fold (Z != 1)."""
    s = _scalars(np.random.default_rng(6), 6)
    pts = treeadd.plain_fixed_base_fold(torch.tensor(s), E.fixed_base_table("cpu"))
    pts = torch.cat([E.encode_point(E.identity((1,))), E.encode_point(E.base_point((1,))), pts])
    pts = np.ascontiguousarray(pts.numpy())
    out = np.zeros((len(pts), 32), np.uint8)
    host.host_compress(len(pts), _ptr(pts), _ptr(out))
    assert np.array_equal(out, powchain.plain_compress(torch.tensor(pts)).numpy())
    want = [oracle.encode_point((0, 1)), oracle.encode_point(oracle.BASE)]
    want += [oracle.encode_point(oracle.scalarmult(oracle.BASE, int.from_bytes(v, "little")))
             for v in (row.tobytes() for row in s)]
    assert [o.tobytes() for o in out] == want


COMPRESS_Z = [0, 1, 2, 19, P - 1, P, P + 1, 2**255 - 1, 2**255, 2**256 - 1]


def _affine_encoding(row: np.ndarray) -> bytes:
    """Python's encoding of (X / Z, Y / Z) from the low 255 bits of each
    coordinate, as the kernels read them (1/0 = 0)."""
    low = (1 << 255) - 1
    x, y, z = (int.from_bytes(row[c].tobytes(), "little") & low for c in range(3))
    zi = pow(z % P, P - 2, P)
    xa, ya = x * zi % P, y * zi % P
    return (ya | (xa & 1) << 255).to_bytes(32, "little")


@pytest.mark.parametrize("z", COMPRESS_Z + ["random"])
def test_compress_lane_z_edges(host, z):
    """K8's lane (1/Z by Bernstein-Yang divsteps) on random X, Y with Z = 0,
    1, 2, 19, p - 1, p, p + 1, 2^255 - 1 (each against the plain version
    and Python's integers) and with bit 255 set (2^255, 2^256 - 1: the
    lane reads the low 255 bits, as the p - 2 chain did; against Python),
    or random Z."""
    rs = np.random.default_rng(len(str(z)))
    pts = rs.integers(0, 256, (6, 4, 32), dtype=np.uint8)
    pts[:, :2, 31] &= 0x7F
    pts[0, :2] = 0  # X = Y = 0
    if z == "random":
        pts[:, 2, 31] &= 0x7F
    else:
        pts[:, 2] = _le(z % 2**256)
    pts = np.ascontiguousarray(pts)
    out = np.zeros((len(pts), 32), np.uint8)
    host.host_compress(len(pts), _ptr(pts), _ptr(out))
    assert [o.tobytes() for o in out] == [_affine_encoding(row) for row in pts]
    if z == "random" or z < 2**255:
        assert np.array_equal(out, powchain.plain_compress(torch.tensor(pts)).numpy())


@pytest.mark.parametrize("case", ["top", "bottom", "random"])
def test_fe_sq_matches_python_at_lazy_bound(host, case):
    """fe_sq at its input bound (every limb below 3 times its width) is
    the square mod p, and equals fe_mul(f, f)."""
    rs = np.random.default_rng(len(case))
    width = np.array([1 << (26 if i % 2 == 0 else 25) for i in range(10)], np.int64)
    if case == "random":
        limbs = rs.integers(-3 * width, 3 * width, (16, 10))
    else:
        sign = 1 if case == "top" else -1
        limbs = np.tile(sign * (3 * width - 1), (16, 1))
        limbs[1:] -= sign * rs.integers(0, width // 4, (15, 10))
    limbs = np.ascontiguousarray(limbs.astype(np.int32))
    sq = np.zeros((len(limbs), 32), np.uint8)
    mul = np.zeros_like(sq)
    host.host_fe_sq(len(limbs), _ptr(limbs), _ptr(sq), _ptr(mul))
    assert np.array_equal(sq, mul)
    for row, got in zip(limbs, sq):
        value = sum(int(v) << ((i * 51 + 1) // 2) for i, v in enumerate(row))
        assert int.from_bytes(got.tobytes(), "little") == value * value % P


def _scalars(rs, n_random: int) -> np.ndarray:
    vals = [0, 1, 15, 16, L - 1, L, 2**256 - 1]
    vals += [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n_random)]
    return np.ascontiguousarray(np.stack([_le(v) for v in vals]))


def _fixed_base_lanes(host, s: np.ndarray, threads: int) -> np.ndarray:
    table = np.ascontiguousarray(E._fixed_base_table())
    out = np.zeros((len(s), 4, 32), np.uint8)
    host.host_fixed_base(len(s), threads, _ptr(s), _ptr(table), _ptr(out))
    return out


def test_fixed_base_lane_matches_plain(host):
    """K4's lane code at every thread count a lane, the shuffle levels
    replayed, against the plain fold: the same bits for every count."""
    s = _scalars(np.random.default_rng(2), 5)
    want = treeadd.plain_fixed_base_fold(torch.tensor(s), E.fixed_base_table("cpu")).numpy()
    for threads in treeadd.THREADS:
        assert np.array_equal(_fixed_base_lanes(host, s, threads), want), threads


FIXED_BASE_EDGES = (0, 1, 8, 15, 16, L - 1, L, 2**256 - 1, int("8" * 64, 16),
                    (8 << 252) | 5, (15 << 252) | (L - 1))  # the top nibble >= 8: a 65th term


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_fixed_base_lane_edge_scalars(host, threads):
    """The recoding's edges (every nibble 8, the carry out of the top
    window) at each thread count: bit-equal to the plain fold, and the
    oracle's [s]B."""
    s = np.ascontiguousarray(np.stack([_le(v) for v in FIXED_BASE_EDGES]))
    got = _fixed_base_lanes(host, s, threads)
    want = treeadd.plain_fixed_base_fold(torch.tensor(s), E.fixed_base_table("cpu")).numpy()
    assert np.array_equal(got, want)
    enc = powchain.plain_compress(torch.tensor(got)).numpy()
    assert [e.tobytes() for e in enc] == [
        oracle.encode_point(oracle.scalarmult(oracle.BASE, v)) for v in FIXED_BASE_EDGES]


def test_window_verify_lane_matches_plain(host):
    rs = np.random.default_rng(3)
    n = 8
    keys = [oracle.keypair(bytes([40 + i])) for i in range(n)]
    msgs = [bytes(rs.integers(0, 256, 16, dtype=np.uint8)) for _ in range(n)]
    sigs = [bytearray(oracle.sign(sk, pk, m)) for (sk, pk), m in zip(keys, msgs)]
    sigs[2][40] ^= 1  # S
    sigs[5][33] ^= 4
    pk = torch.tensor(np.stack([np.frombuffer(k[1], np.uint8) for k in keys]))
    sig = torch.tensor(np.stack([np.frombuffer(bytes(s), np.uint8) for s in sigs]))
    msg = torch.tensor(np.stack([np.frombuffer(m, np.uint8) for m in msgs]))
    pts, _ = E.decompress(torch.cat([pk, sig[:, :32]]))
    left = E.fixed_base_mult(sig[:, 32:])
    h = sha512.sha512_mod_l(torch.cat([sig[:, :32], pk, msg], dim=1))
    a, r = pts[:n].contiguous().numpy(), pts[n:].contiguous().numpy()
    ok = np.zeros(n, np.uint8)
    host.host_window_verify(n, _ptr(a), _ptr(h.numpy()), _ptr(r), _ptr(left.numpy()), _ptr(ok))
    want = ladder.plain_window_verify(pts[:n], h, pts[n:], left)
    assert np.array_equal(ok.astype(bool), want.numpy())
    assert ok.tolist() == [1, 1, 0, 1, 1, 0, 1, 1]


def _window_inputs(nbytes: int, S: int):
    """K3''s lanes: the identity, B, [s]B from the plain K4 fold (Z != 1),
    decompressed keys (16 at most, then repeated) and one invalid
    encoding's point, beside the edge scalars 0, 1, 15, 16, L - 1 and all
    ones, then random scalars."""
    rs = np.random.default_rng(nbytes + S)
    ends = torch.cat([E.encode_point(E.identity((1,))), E.encode_point(E.base_point((1,)))])
    sb = treeadd.plain_fixed_base_fold(torch.tensor(_scalars(rs, 2)), E.fixed_base_table("cpu"))
    keys = torch.tensor(np.stack([np.frombuffer(oracle.keypair(bytes([90 + i]))[1], np.uint8)
                                  for i in range(min(S, 16))] + [_le(2)]))
    pts = torch.cat([ends, sb, decompress.plain_decompress(keys)[0]])
    pts = pts.repeat(-(-S // len(pts)), 1, 1)[:S].contiguous()
    top = 2 ** (8 * nbytes) - 1
    edges = [v.to_bytes(max(nbytes, 32), "little")[:nbytes] for v in (0, 1, 15, 16, L - 1)]
    edges.append(top.to_bytes(nbytes, "little"))
    k = np.concatenate([np.stack([np.frombuffer(e, np.uint8) for e in edges]),
                        rs.integers(0, 256, (S, nbytes), dtype=np.uint8)])[:S]
    return np.ascontiguousarray(pts.numpy()), np.ascontiguousarray(k)


@pytest.mark.parametrize("nbytes", [16, 32])
def test_window_mult_lane_matches_plain(host, nbytes):
    pts, k = _window_inputs(nbytes, 12)
    out = np.zeros_like(pts)
    host.host_window_mult(len(pts), nbytes, _ptr(pts), _ptr(k), _ptr(out))
    want = ladder.plain_window_mult(torch.tensor(pts), torch.tensor(k))
    assert np.array_equal(out, want.numpy())


def _recode_scalars(nbytes: int) -> list:
    """0, 1, 4, 8, 15, 16, L - 1 (cut to nbytes), all ones, top nibbles of
    8 and of 15, a digit of 4 in every window (0b100 repeated: each
    carries), then random values."""
    top = 2 ** (8 * nbytes) - 1
    fours = sum(4 << (3 * i) for i in range(-(-8 * nbytes // 3))) & top
    vals = [0, 1, 4, 8, 15, 16, (L - 1) & top, top, 8 << (8 * nbytes - 4),
            15 << (8 * nbytes - 4), int("8" * 2 * nbytes, 16), fours]
    rs = np.random.default_rng(nbytes)
    return vals + [int.from_bytes(rs.bytes(nbytes), "little") for _ in range(6)]


@pytest.mark.parametrize("W", [ladder.WINDOW_BITS, ladder.WARP_WINDOW_BITS])
@pytest.mark.parametrize("nbytes", [16, 32])
def test_recoding_matches_plain_and_integers(host, nbytes, W):
    """window.cuh's recoding in windows of W bits (a lane's, and a warp's
    with one point): the carry digit and nwin = ceil(8 nbytes / W)
    digits in [-2^(W-1), 2^(W-1)), most significant first, equal to
    ``ladder.signed_digits``'s, with sum d_i 2^(W i) + carry 2^(W nwin) =
    k."""
    nwin = -(-8 * nbytes // W)
    vals = _recode_scalars(nbytes)
    k = np.ascontiguousarray(np.stack([_le(v)[:nbytes] for v in vals]))
    digits = np.zeros((len(vals), 1 + nwin), np.int32)
    host.host_recode(len(vals), nbytes, W, _ptr(k), _ptr(digits))
    top, dig = ladder.signed_digits(torch.tensor(k), W)
    assert np.array_equal(digits[:, 0], top.numpy())
    assert np.array_equal(digits[:, 1:], dig.numpy()[:, ::-1])
    half = 1 << (W - 1)
    assert digits[:, 1:].min() >= -half and digits[:, 1:].max() < half
    assert set(digits[:, 0]) <= {0, 1}
    for v, row in zip(vals, digits):
        assert sum(int(d) << (W * i) for i, d in enumerate(row[:0:-1])) + \
            (int(row[0]) << (W * nwin)) == v


def _one_point_warps(nbytes: int, S: int):
    """K3''s lanes where warps hold one point: lanes 0-31 the point [s]B
    (Z != 1), 32-63 the window inputs' distinct points, 64 on a key."""
    pts, k = _window_inputs(nbytes, S)
    pts[:32] = pts[4]
    pts[64:] = pts[40]
    return np.ascontiguousarray(pts), k


@pytest.mark.parametrize("nbytes", [16, 32])
def test_window_mult_lane_warp_point_matches_plain(host, nbytes):
    """Warps with one point take the warp's one table (signed 4-bit
    windows), others their lanes' own (3-bit); each lane bit-equal to the
    plain version, which picks the same chain (``warp_point_lanes``)."""
    pts, k = _one_point_warps(nbytes, 70)
    out = np.zeros_like(pts)
    host.host_window_mult(len(pts), nbytes, _ptr(pts), _ptr(k), _ptr(out))
    lanes = ladder.warp_point_lanes(torch.tensor(pts))
    assert lanes.tolist() == [True] * 32 + [False] * 32 + [True] * 6
    want = ladder.plain_window_mult(torch.tensor(pts), torch.tensor(k))
    assert np.array_equal(out, want.numpy())


def test_window_verify_lane_one_key_matches_plain(host):
    """K3 on 40 signatures by one key (a warp with one point, then a
    ragged one), one in four corrupted: verdicts equal the plain
    version's and the oracle's."""
    sk, pk1 = oracle.keypair(bytes([77]))
    n = 40
    msgs = [bytes([i]) * 8 for i in range(n)]
    sigs = [bytearray(oracle.sign(sk, pk1, m)) for m in msgs]
    for i in range(0, n, 4):
        sigs[i][40 + i % 24] ^= 2
    pk = torch.tensor(np.frombuffer(pk1, np.uint8)).repeat(n, 1)
    sig = torch.tensor(np.stack([np.frombuffer(bytes(s), np.uint8) for s in sigs]))
    msg = torch.tensor(np.stack([np.frombuffer(m, np.uint8) for m in msgs]))
    pts, _ = E.decompress(torch.cat([pk, sig[:, :32]]))
    left = E.fixed_base_mult(sig[:, 32:].contiguous())
    h = sha512.sha512_mod_l(torch.cat([sig[:, :32], pk, msg], dim=1))
    a, r = pts[:n].contiguous().numpy(), pts[n:].contiguous().numpy()
    ok = np.zeros(n, np.uint8)
    host.host_window_verify(n, _ptr(a), _ptr(h.numpy()), _ptr(r), _ptr(left.numpy()), _ptr(ok))
    want = ladder.plain_window_verify(pts[:n], h, pts[n:], left)
    assert np.array_equal(ok.astype(bool), want.numpy())
    assert ok.tolist() == [oracle.verify(pk1, m, bytes(s)) for m, s in zip(msgs, sigs)]


def _sum8(host, nz: int, na: int):
    """K3''s sum on the host and by the plain version: nz 16-byte lanes
    (the R set) and na 32-byte ones (the A set)."""
    r, z = _window_inputs(16, nz) if nz else (np.zeros((0, 4, 32), np.uint8),
                                              np.zeros((0, 16), np.uint8))
    a, w = _window_inputs(32, na) if na else (np.zeros((0, 4, 32), np.uint8),
                                              np.zeros((0, 32), np.uint8))
    out = np.zeros((1, 4, 32), np.uint8)
    host.host_window_mult_sum8(na, _ptr(a), _ptr(w), nz, _ptr(r), _ptr(z), _ptr(out))
    want = ladder.plain_window_mult_sum8(*(torch.tensor(x) for x in (r, z, a, w)))
    return out, want.numpy()


@pytest.mark.parametrize("S", [1, 5, 31, 33, 70, 1024 + 32])
def test_window_mult_fold_matches_plain(host, S):
    """The sum's pairing over one set: one block, ragged ones, two and
    three blocks, and 33 blocks (an odd node passed up at each level)."""
    out, want = _sum8(host, S, 0)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("nz,na", [(1, 1), (70, 33), (64, 1), (0, 40)])
def test_window_mult_sum8_matches_plain(host, nz, na):
    """Both sets in one sum, the A set's blocks first, then [8]."""
    out, want = _sum8(host, nz, na)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("nbytes", [4, 32, 64])
def test_scalar_mult_lane_matches_plain(host, nbytes):
    """K3'''s lane on the window tests' points and scalars, the bits packed
    as the wrapper packs them: canonical X, Y, Z, T equal to the plain
    ladder's, and the affine point the oracle's."""
    pts, k = _window_inputs(nbytes, 10)
    bits = torch.tensor(np.unpackbits(k, axis=1, bitorder="little").astype(np.int32))
    words = np.ascontiguousarray(ladder.pack_bits(bits).numpy())
    out = np.zeros_like(pts)
    host.host_scalar_mult(len(pts), words.shape[0], _ptr(pts), _ptr(words), _ptr(out))
    assert np.array_equal(out, ladder.plain_scalar_mult(torch.tensor(pts), bits).numpy())
    for pt, kk, got in zip(pts, k, out):
        x, y, z = (int.from_bytes(got[c].tobytes(), "little") for c in range(3))
        px, py, pz = (int.from_bytes(pt[c].tobytes(), "little") for c in range(3))
        zi, pzi = pow(z, P - 2, P), pow(pz, P - 2, P)
        k_int = int.from_bytes(kk.tobytes(), "little")
        assert (x * zi % P, y * zi % P) == oracle.scalarmult((px * pzi % P, py * pzi % P), k_int)


def _small_order_points() -> list:
    """(0, -1) of order 2 and (sqrt(-1), 0) of order 4, as canonical
    (X, Y, Z, T) with Z = 1."""
    i = pow(2, (P - 1) // 4, P)
    return [np.stack([_le(0), _le(P - 1), _le(1), _le(0)]),
            np.stack([_le(i), _le(0), _le(1), _le(0)])]


def _doubling_points(case: str) -> np.ndarray:
    """uint8 [N, 4, 32] points for the doubling: the identity, B, [s]B from
    the plain K4 fold (Z != 1), points of small order, or decompressed
    keys with every coordinate times a random lambda (Z = lambda)."""
    rs = np.random.default_rng(21)
    if case == "identity":
        return E.encode_point(E.identity((1,))).numpy()
    if case == "base":
        return E.encode_point(E.base_point((1,))).numpy()
    if case == "sB":
        return treeadd.plain_fixed_base_fold(torch.tensor(_scalars(rs, 4)),
                                             E.fixed_base_table("cpu")).numpy()
    if case == "small_order":
        return np.ascontiguousarray(np.stack(_small_order_points()))
    keys = torch.tensor(np.stack([np.frombuffer(oracle.keypair(bytes([40 + i]))[1], np.uint8)
                                  for i in range(6)]))
    rows = []
    for pt in decompress.plain_decompress(keys)[0].numpy():
        lam = int(rs.integers(2, 2**62)) * int(rs.integers(1, 2**62)) % P
        rows.append(np.stack([_le(int.from_bytes(c.tobytes(), "little") * lam % P) for c in pt]))
    return np.ascontiguousarray(np.stack(rows))


@pytest.mark.parametrize("case", ["identity", "base", "sB", "small_order", "random"])
def test_ge_add_self_matches_unified_addition(host, case):
    """q + q by squarings (the doubling K3''s bound counts) returns
    ge_add(q, q)'s coordinates: canonical X, Y, Z, T equal, and equal to
    the plain version's unified addition."""
    pts = _doubling_points(case)
    by_self, by_add = np.zeros_like(pts), np.zeros_like(pts)
    host.host_ge_add_self(len(pts), _ptr(pts), _ptr(by_self), _ptr(by_add))
    assert np.array_equal(by_self, by_add)
    q = E.decode_point(torch.tensor(pts))
    assert np.array_equal(by_self, E.encode_point(E.point_add(q, q)).numpy())


@pytest.mark.parametrize("k", ["zero", "ones256", "ones512", "top512"])
def test_scalar_mult_lane_edge_scalars(host, k):
    """K3'''s lane at k = 0, all ones (256 and 512 bits) and 2^511 on the
    identity, B, [s]B and points of small order: canonical X, Y, Z, T equal
    to the plain ladder's, the affine point the oracle's."""
    pts = np.ascontiguousarray(np.concatenate(
        [_window_inputs(32, 4)[0], np.stack(_small_order_points())]))
    nbits = 512 if k.endswith("512") else 256
    value = {"zero": 0, "ones256": 2**256 - 1, "ones512": 2**512 - 1, "top512": 2**511}[k]
    bits = torch.tensor([[(value >> t) & 1 for t in range(nbits)]] * len(pts), dtype=torch.int32)
    words = np.ascontiguousarray(ladder.pack_bits(bits).numpy())
    out = np.zeros_like(pts)
    host.host_scalar_mult(len(pts), words.shape[0], _ptr(pts), _ptr(words), _ptr(out))
    assert np.array_equal(out, ladder.plain_scalar_mult(torch.tensor(pts), bits).numpy())
    for pt, got in zip(pts, out):
        x, y, z = (int.from_bytes(got[c].tobytes(), "little") for c in range(3))
        px, py, pz = (int.from_bytes(pt[c].tobytes(), "little") for c in range(3))
        zi, pzi = pow(z, P - 2, P), pow(pz, P - 2, P)
        assert (x * zi % P, y * zi % P) == oracle.scalarmult((px * pzi % P, py * pzi % P), value)


def test_pow_chain_lanes_match_plain(host):
    """K8' and the p - 2 chain on edge encodings (bit 255 set among them),
    keys and random bytes, against their plain versions and Python's pow."""
    a = _encodings(np.random.default_rng(13), 6)
    for name, plain, e in (("host_sqrt_chain", powchain.plain_sqrt_chain, (P - 5) // 8),
                           ("host_inv_chain", powchain.plain_inv_chain, P - 2)):
        out = np.zeros_like(a)
        getattr(host, name)(len(a), _ptr(a), _ptr(out))
        assert np.array_equal(out, plain(torch.tensor(a)).numpy()), name
        for row, got in zip(a, out):
            v = int.from_bytes(row.tobytes(), "little") & ((1 << 255) - 1)
            assert int.from_bytes(got.tobytes(), "little") == pow(v, e, P), name


@pytest.mark.parametrize("e", [0, 1, 2, 37, (P - 5) // 8, P - 1, 2**255 - 1, 2**1023 + 5],
                         ids=["0", "1", "2", "37", "sqrt", "p-1", "2^255-1", "2^1023+5"])
def test_pow_lane_matches_plain(host, e):
    """K8'' over the exponent's words as the launcher passes them, up to
    the kernel's 1 024 bits."""
    a = _encodings(np.random.default_rng(14), 3)
    nbits = e.bit_length()
    words = np.array([(e >> (32 * i)) & 0xFFFFFFFF for i in range(max(-(-nbits // 32), 1))],
                     np.uint32)
    out = np.zeros_like(a)
    host.host_pow(len(a), nbits, _ptr(words), _ptr(a), _ptr(out))
    assert np.array_equal(out, powchain.plain_pow_exp(torch.tensor(a), e).numpy())
    for row, got in zip(a, out):
        v = int.from_bytes(row.tobytes(), "little") & ((1 << 255) - 1)
        assert int.from_bytes(got.tobytes(), "little") == pow(v, e, P)


def test_fieldmul_probe_lane_matches_plain_and_integers(host):
    rs = np.random.default_rng(12)
    a = rs.integers(0, 256, (9, 32), dtype=np.uint8)
    b = rs.integers(0, 256, (9, 32), dtype=np.uint8)
    a[0], b[0] = 0, 255  # zero, and all ones (bit 255 dropped)
    a[1] = b[1] = np.frombuffer(_le(P - 1), np.uint8)
    out = np.zeros_like(a)
    host.host_fieldmul_probe(len(a), _ptr(a), _ptr(b), _ptr(out))
    assert np.array_equal(out, fieldmul_probe.plain_fieldmul_probe(
        torch.tensor(a), torch.tensor(b)).numpy())
    low = (1 << 255) - 1
    for ai, bi, got in zip(a, b, out):
        x = int.from_bytes(ai.tobytes(), "little") & low
        y = pow(int.from_bytes(bi.tobytes(), "little") & low, fieldmul_probe.DEPTH, P)
        want = sum((x + c) * y for c in range(fieldmul_probe.CHAINS)) % P
        assert int.from_bytes(got.tobytes(), "little") == want


def _majority_case(rs, G, S, P, K, shared):
    """K9 inputs: every code an int8 can hold (real codes in the first half
    of a row), a row with no valid responder and an exact tie."""
    a = rs.integers(-128, 128, (G, S, P, K)).astype(np.int8)
    a[..., : K // 2] = rs.integers(0, 3, (G, S, P, K // 2))
    v = rs.random((G, 1 if shared else S, P, K)) < 0.5
    v[0, 0, 0] = False  # no valid responder: the fallback
    tie = np.zeros(K, np.int8)
    tie[1::2] = 1  # an exact tie wherever K is even and every slot counts
    a[0, 0, -1], v[0, 0, -1] = tie, True
    f = rs.integers(0, 3, (G, S, P)).astype(np.int8)
    want = majority.plain_masked_majority_rows(torch.tensor(a), torch.tensor(v), torch.tensor(f))
    return a, v, f, want.numpy().reshape(-1)


def _placed(x: np.ndarray, offset: int) -> np.ndarray:
    """A copy of x starting ``offset`` bytes past a 64-byte boundary, with
    slack either side: the kernels read the 16-byte aligned chunks that
    overlap a tensor, which a card allocation always holds."""
    raw = np.zeros(x.nbytes + 160, np.uint8)
    start = (-raw.ctypes.data) % 64 + 64 + offset
    out = raw[start:start + x.nbytes].view(x.dtype).reshape(x.shape)
    out[...] = x
    return out


def _host_majority(host, a, v, f, S, P, offsets):
    """K9 replayed with answers, mask and fallback at the given offsets."""
    (oa, ov, of) = offsets
    G, _, _, K = a.shape
    a, v, f = _placed(a, oa), _placed(v.view(np.uint8), ov), _placed(f, of)
    out = np.zeros(G * S * P, np.int8)
    assert host.host_majority(G * S * P, K, S, P, _ptr(a), _ptr(v), _ptr(f), _ptr(out)) == 0
    return out


MAJ_OFFSETS = [(0, 0, 0), (1, 0, 3), (3, 7, 1), (6, 6, 15)]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("K", [1, 7, 10, 33, 128, 1024, 1025])
def test_majority_rows_match_plain(host, K, shared):
    """K9 as launched, replayed: tiles of 512 rows for K <= 32 (staged,
    realigned words), a warp a row above (16-byte chunks, the mask
    realigned where its row sits elsewhere mod 16); every code an int8 can
    hold, rows with no valid responder and exact ties; dense (R = 700, not
    a multiple of the tile) and shared-mask ([14, 5, 10, K]: tiles that
    cross g boundaries); answers, mask and fallback at offsets that are
    not 4-byte aligned."""
    G, S, P = (14, 5, 10) if shared else (1, 1, 700)
    a, v, f, want = _majority_case(np.random.default_rng(K), G, S, P, K, shared)
    for offsets in MAJ_OFFSETS:
        assert np.array_equal(_host_majority(host, a, v, f, S, P, offsets), want), offsets


@pytest.mark.parametrize("G,S,P,K", [(2, 3, 300, 10), (3, 4, 150, 7), (1, 2, 1100, 5),
                                     (60, 10, 10, 10), (40, 16, 1, 16), (3, 5, 129, 32)])
def test_majority_tile_layouts_match_plain(host, G, S, P, K):
    """K9's tile kernel on each tiling: tiles inside one (g, s) run of P
    rows (P > 128: a partial tile a run, two and three tiles a run), runs
    of consecutive rows over the mask rows of the g they touch (config
    #2's level-1 shape at G = 60, the m = 2 sweep's level at P = 1)."""
    a, v, f, want = _majority_case(np.random.default_rng(G * P + K), G, S, P, K, True)
    for offsets in MAJ_OFFSETS:
        assert np.array_equal(_host_majority(host, a, v, f, S, P, offsets), want), offsets


def test_majority_rejects_unsupported_shapes(host):
    """S or P of 2^30 or more, and 2^31 rows or more, are refused before
    anything is read."""
    for R, K, S, P in ((2**30, 4, 2**30, 1), (2**30, 4, 1, 2**30), (2**31, 33, 2, 2**29),
                       (2**31, 4, 4, 2**29)):
        assert host.host_majority(R, K, S, P, 0, 0, 0, 0) == 1


COIN_NS = [1, 4, 5, 31, 32, 33, 96, 300, 1024]


@pytest.mark.parametrize("n", COIN_NS)
def test_coin_counts_match_coin_bits(host, n):
    """K1's word-batched ATTACK-coin counts of each asker against
    ``rng.coin_bits(kb, (n, n))`` (coin [i, j] of asker i and responder j)
    of the same key: random asker masks and responder lists that overlap
    (self pairs), each a dense and a sparse draw.  The words drawn are the
    distinct words that hold a needed coin: each once."""
    rs = np.random.default_rng(n)
    for density in (0.9, 0.1):
        k0, k1 = (int(x) for x in rs.integers(0, 2**32, 2))
        ask = (rs.random(n) < density).astype(np.uint8)
        resp = (rs.random(n) < density / 2).astype(np.uint8)
        resp[rs.integers(0, n)] = ask[rs.integers(0, n)] = 1
        ones = np.zeros(n, np.int32)
        drawn = host.host_coin_counts(n, k0, k1, _ptr(ask), _ptr(resp), _ptr(ones))
        coins = rng.coin_bits(torch.tensor([k0, k1]), (n, n)).numpy().astype(np.int64)
        need = ask.astype(bool)[:, None] & resp.astype(bool)[None, :] & ~np.eye(n, dtype=bool)
        assert np.array_equal(ones, (coins * need).sum(1)), density
        nw2 = -(-n * n // 32)
        i, j = np.nonzero(need)
        assert drawn == len(np.unique((i * n + j) % nw2)), density


@pytest.mark.parametrize("n", COIN_NS)
def test_round1_coins_match_coin_bits(host, n):
    """A faulty leader's round-1 coins, 32 to a word: each needed
    recipient's coin is ``rng.coin_bits(ka, (n,))``'s, each word that holds
    one drawn once."""
    rs = np.random.default_rng(n + 1)
    k0, k1 = (int(x) for x in rs.integers(0, 2**32, 2))
    need = (rs.random(n) < 0.6).astype(np.uint8)
    coin = np.zeros(n, np.int8)
    drawn = host.host_round1_coins(n, k0, k1, _ptr(need), _ptr(coin))
    want = rng.coin_bits(torch.tensor([k0, k1]), (n,)).numpy()
    assert np.array_equal(coin, np.where(need.astype(bool), want, -1))
    assert drawn == len(np.unique(np.nonzero(need)[0] % -(-n // 32)))


def _masks_with(rs, cap, k, taken=None):
    """``cap`` bits with k set at random positions (not in ``taken``)."""
    free = np.ones(cap, bool) if taken is None else ~taken
    bits = np.zeros(cap, bool)
    bits[rs.choice(np.nonzero(free)[0], k, replace=False)] = True
    return bits


def _pack(bits):
    return np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1).view(">u4")[:, 0].astype(np.uint32)


@pytest.mark.parametrize("lanes,words", [(1, 1), (2, 1), (16, 1), (32, 1), (1, 2), (8, 2),
                                         (16, 2)])
def test_relay_word_matches_plain_counts(host, lanes, words):
    """K2's packed relay word: a lane's capped traitor counts and honest
    flags of both values over its mask words packed, summed over the
    instance's lanes,
    unpacked and thresholded, against the plain version's separate counts
    and its threshold rule (``plain_fused_signed_sweep_step``) at traitor
    holder counts 0, 8, 9, 10, 32 and up to 1 024, honest holders or none,
    the chain bound open or closed."""
    rs = np.random.default_rng(lanes * 10 + words)
    cap = lanes * words * 32
    ks = sorted({k for k in (0, 1, 8, 9, 10, 32, 100, 511, 1024) if k <= cap})
    for k_r in ks:
        for k_a in (ks[0], ks[-1], ks[len(ks) // 2]):
            for held_r, held_a in ((0, 0), (1, 0), (0, 3)):
                traitor = np.zeros(cap, bool)
                seen_r = _masks_with(rs, cap, k_r)
                seen_a = _masks_with(rs, cap, k_a)
                traitor |= seen_r | seen_a
                free = ~traitor
                honest = np.zeros(cap, bool)
                for seen, h in ((seen_r, held_r), (seen_a, held_a)):
                    if h and free.sum() >= h:
                        extra = _masks_with(rs, cap, h, ~free)
                        seen |= extra
                        honest |= extra
                        free &= ~extra
                for chain_ok in (0, 1):
                    out = np.zeros(3, np.int32)
                    masks = [np.ascontiguousarray(_pack(m))
                             for m in (seen_r, seen_a, honest, traitor)]
                    host.host_relay(lanes, words, *(_ptr(w) for w in masks), chain_ok,
                                    _ptr(out))
                    total = int(out[0]) & 0xFFFFFFFF
                    for v, seen in ((0, seen_r), (1, seen_a)):
                        k = int((seen & traitor).sum())
                        held = bool((seen & honest).any())
                        field = (total >> (9 * v)) & 0x1FF
                        assert (field >= 9) == (k >= 9) and (k >= 9 or field == k)
                        lanes_held = int((seen & honest).reshape(lanes, -1).any(1).sum())
                        assert (total >> (18 + 6 * v)) & 0x3F == lanes_held
                        kt = torch.tensor(k)
                        t8 = torch.where(kt > 8, 256, 256 - (256 >> kt.clamp(max=8)))
                        want = 256 if held else (int(t8) if chain_ok else 0)
                        assert out[1 + v] == want, (k_r, k_a, held_r, held_a, chain_ok, v)
