"""Batched Ed25519 signing and verification over torch tensors, through
the Ed25519 kernels.

The port of ``ba_tpu/crypto/ed25519.py``'s sign and verify paths.
Verify checks the RFC 8032 equation without cofactor multiplication,

    [S]B == R + [h]A,   h = SHA-512(R || A || M) mod L,

with the same semantics as the pure-Python oracle (``crypto/oracle.py``)
lane for lane.  :func:`verify` composes four kernel wrappers, each of
which runs its plain version on a CPU tensor and its hand-written CUDA
kernel on a CUDA one:

- K7 ``ops/decompress.decompress``: A and R in one 2B-lane call;
- K4 ``ops/treeadd.fixed_base_fold``: [S]B from the window table of
  [j 16^w]B in signed 4-bit digits, 65 entries folded by mixed and
  complete additions;
- K5 ``ops/sha512_kernel.sha512_blocks_mod_l``: h;
- K3 ``ops/ladder.window_verify``: [h]A by signed 3-bit windows, R + [h]A, and
  the projective equality with [S]B, one verdict a lane.

Between kernels a point is uint8 [N, 4, 32]: the canonical little-endian
encodings of X, Y, Z and T (:func:`encode_point`).  The plain field
arithmetic (``crypto/field.py``) works on (X, Y, Z, T) tuples of [..., 22]
limb tensors; :func:`point_add`, :func:`point_dbl` and :func:`point_eq`
are the formulas the kernels evaluate, term for term.

:func:`sign` (RFC 8032 5.1.6) composes five wrappers in six launches:
K5' ``ops/sha512_kernel.sha512_blocks`` for the key expansion, K5 for
the nonce r and the challenge k, K4 for R = [r]B, K8
``ops/powchain.compress`` for R's encoding and K6
``ops/modl.reduce_mod_l_planes`` for S = (r + k a) mod L, with
``scalar.muladd_bytes`` (torch) before it.

:func:`verify_rlc` is the random-linear-combination batch check
(``ba_tpu/crypto/ed25519.py:314``): one cofactored equation for a whole
batch, through K7, K5, K6 (the mod-L reductions of ``scalar.mul_bytes``
and ``scalar.sum_bytes``), K3' ``ops/ladder.window_mult_sum8`` (the
right side, [8](sum [z]R + sum [W]A), in one launch), K4 for the left
side [8c]B and K8 for the comparison.

:func:`scalar_mult` and :func:`scalar_mult_base`
(``ba_tpu/crypto/ed25519.py:100-120``) are [k]P by double-and-add-always
on limb-form points, the scalar as bits ``[..., nbits]``, LSB first.  On
a CPU tensor they run :func:`ladder`, the reference's loop; on a CUDA
one the point is encoded, K3'' ``ops/ladder.scalar_mult`` (the port of
``ba_tpu/ops/ladder.py:53 _ladder_kernel``) runs the loop, and the
product comes back as canonical limbs.  Either way its canonical X, Y, Z
and T are the reference's.  They have no production caller, here or in
the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.crypto.oracle import B_X, B_Y, D, L, P

Point = tuple  # (X, Y, Z, T) limb tensors, shapes [..., 22]


def identity(shape, device=None) -> Point:
    z = F.zeros(shape, device)
    one = F.constant(1, device).expand(*shape, F.LIMBS)
    return (z, one, one, z)


def base_point(shape, device=None) -> Point:
    return tuple(F.constant(c, device).expand(*shape, F.LIMBS)
                 for c in (B_X, B_Y, 1, B_X * B_Y % P))


def point_add(p: Point, q: Point) -> Point:
    """Complete unified addition (add-2008-hwcd-3, a = -1): 8 multiplies
    and one small one.  Valid for doubling too; inputs carried (every mul
    output is) or canonical."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    dev = x1.device
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, t2), F.constant(2 * D % P, dev))
    d = F.mul_small(F.mul(z1, z2), 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_add_cached(p: Point, q: tuple) -> Point:
    """p + q for q a fixed-base table entry in the cached form (Y - X,
    Y + X, 2d T) at Z = 1: add-2008-hwcd-3 with Z2 = 1, 7 multiplies, the
    values of :func:`point_add` on (x, y, 1, x y), term for term as K4's
    ``ge_add_affine`` (``ops/csrc/treeadd.cu``)."""
    x1, y1, z1, t1 = p
    ymx, ypx, t2d = q
    a = F.mul(F.sub(y1, x1), ymx)
    b = F.mul(F.add(y1, x1), ypx)
    c = F.mul(t1, t2d)
    d = F.mul_small(z1, 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_select(mask: torch.Tensor, p: Point, q: Point) -> Point:
    """Per-lane select (``ba_tpu/crypto/ed25519.py:94``): mask [...] bool
    -> p where True, else q."""
    m = mask[..., None]
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def ladder(point: Point, bits: torch.Tensor) -> Point:
    """[k]P by double-and-add-always, the reference's loop and K3''s plain
    version, on any device: per bit, LSB first, acc = select(bit,
    acc + q, acc), then q = q + q by the unified addition."""
    acc = identity(bits.shape[:-1], bits.device)
    q = tuple(c.expand(*bits.shape[:-1], F.LIMBS) for c in point)
    for t in range(bits.shape[-1]):
        acc = point_select(bits[..., t] == 1, point_add(acc, q), acc)
        q = point_add(q, q)
    return acc


def scalar_mult(point: Point, bits: torch.Tensor) -> Point:
    """[k]P: point limbs [..., 22] x 4, bits [..., nbits] 0/1, LSB first
    (nbits a multiple of 32 on the card) -> point limbs.  A CPU tensor
    runs :func:`ladder`; a CUDA one runs K3''
    (``ops/ladder.scalar_mult``), or raises."""
    if bits.device.type == "cpu":
        return ladder(point, bits)
    from ba_tpu_torch.ops.ladder import scalar_mult as k3pp

    shape, nbits = bits.shape[:-1], bits.shape[-1]
    pts = encode_point(tuple(c.expand(*shape, F.LIMBS) for c in point))
    out = k3pp(pts.reshape(-1, 4, 32).contiguous(), bits.reshape(-1, nbits))
    return decode_point(out.reshape(*shape, 4, 32))


def scalar_mult_base(bits: torch.Tensor) -> Point:
    """[k]B for the base point B (``ba_tpu/crypto/ed25519.py:119``)."""
    return scalar_mult(base_point(bits.shape[:-1], bits.device), bits)


def point_dbl(p: Point, with_t: bool = True) -> Point:
    """Dedicated doubling (dbl-2008-hwcd, a = -1; ``ba_tpu/ops/planes.py:
    182``): A = X^2, B = Y^2, C = 2 Z^2, E = 2 X Y, G = B - A, F = G - C,
    H = -(A + B); out (E F, G H, F G, E H).  The input T is never read;
    with_t=False leaves T zero.  G is carried so that F stays
    multiply-safe."""
    x, y, z, _ = p
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul_small(F.mul(z, z), 2)
    e = F.mul_small(F.mul(x, y), 2)
    g = F.carry(F.sub(b, a))
    f = F.sub(g, c)
    h = F.sub(torch.zeros_like(a), F.add(a, b))
    t = F.mul(e, h) if with_t else torch.zeros_like(a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def point_eq(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return F.eq(F.mul(x1, z2), F.mul(x2, z1)) & F.eq(F.mul(y1, z2), F.mul(y2, z1))


def encode_point(p: Point) -> torch.Tensor:
    """(X, Y, Z, T) limbs [..., 22] -> uint8 [..., 4, 32], each coordinate
    its canonical encoding: the kernels' point layout."""
    return torch.stack([F.to_bytes(c) for c in p], dim=-2)


def decode_point(enc: torch.Tensor) -> Point:
    """uint8 [..., 4, 32] -> (X, Y, Z, T) limbs [..., 22]."""
    return tuple(F.from_bytes(enc[..., c, :]) for c in range(4))


@functools.lru_cache(maxsize=None)
def _bound_bytes(bound: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(list(bound.to_bytes(32, "little")), dtype=torch.int64, device=device)


def _lt_const(by: torch.Tensor, bound: int) -> torch.Tensor:
    """Little-endian uint8 [..., 32] < bound: the sign of sum_i
    sign(by_i - bound_i) 2^i, whose highest nonzero term outweighs the
    rest (the reference compares byte by byte from the top)."""
    diff = torch.sign(by.to(torch.int64) - _bound_bytes(bound, by.device))
    return (diff << torch.arange(32, device=by.device)).sum(dim=-1) < 0


@functools.lru_cache(maxsize=None)
def _base_table() -> np.ndarray:
    """Fixed-base window table: [64, 16, 4, 22] int32, T[w, j] = [j * 16^w]B
    in affine-extended limbs (Z = 1, T = X Y), built with the oracle's
    affine additions; row j = 0 is the identity."""
    from ba_tpu_torch.crypto import oracle

    table = np.zeros((64, 16, 4, F.LIMBS), np.int32)
    step = oracle.BASE
    for w in range(64):
        pt = (0, 1)
        for j in range(16):
            x, y = pt
            for c, v in enumerate((x, y, 1, x * y % P)):
                table[w, j, c] = F._np_limbs(v)
            if j < 15:
                pt = oracle.edwards_add(pt, step)
        step = oracle.edwards_add(pt, step)  # [16^(w+1)]B from [15 * 16^w]B
    return table


FB_ROWS, FB_ENTRIES, FB_ENTRY_WORDS = 65, 8, 32  # K4's table (ops/csrc/treeadd.cu)


def _radix25_limbs(v: int) -> list:
    """The kernels' 10 limbs of 0 <= v < 2^255 (radix 2^25.5: limb i of
    26 bits for even i, 25 for odd, at bit ceil(25.5 i))."""
    return [(v >> ((51 * i + 1) // 2)) & ((1 << (26 - (i & 1))) - 1) for i in range(10)]


@functools.lru_cache(maxsize=None)
def _fixed_base_table() -> np.ndarray:
    """K4's window table: int32 [65, 8, 32].  Entry j - 1 of row w < 64 is
    [j 16^w]B (:func:`_base_table`'s T[w, j], j = 1..8), of row 64
    [j 2^256]B, the recoding's carry out of the top window; each in the
    cached form at Z = 1, (y - x, y + x, 2d x y), as 10 canonical limbs of
    the kernels' radix (:func:`_radix25_limbs`) a coordinate, then two zero
    words."""
    from ba_tpu_torch.crypto import oracle

    weights = 1 << (12 * np.arange(F.LIMBS, dtype=object))
    base = _base_table()
    pts = [[tuple(int((base[w, j, c].astype(object) * weights).sum()) for c in (0, 1))
            for j in range(1, FB_ENTRIES + 1)] for w in range(64)]
    top = oracle.scalarmult(oracle.BASE, 1 << 256)
    row, pt = [], top
    for _ in range(FB_ENTRIES):
        row.append(pt)
        pt = oracle.edwards_add(pt, top)
    pts.append(row)
    table = np.zeros((FB_ROWS, FB_ENTRIES, FB_ENTRY_WORDS), np.int32)
    for w in range(FB_ROWS):
        for j, (x, y) in enumerate(pts[w]):
            coords = ((y - x) % P, (y + x) % P, 2 * D * x * y % P)
            table[w, j, :30] = sum((_radix25_limbs(v) for v in coords), [])
    return table


def fixed_base_table(device) -> torch.Tensor:
    """K4's window table (int32 [65, 8, 32]) on ``device``, made once per
    device."""
    return _fixed_base_table_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _fixed_base_table_on(device: torch.device) -> torch.Tensor:
    return torch.tensor(_fixed_base_table(), device=device)


def decompress(by: torch.Tensor):
    """32-byte encodings [N, 32] -> (uint8 [N, 4, 32] points, bool [N]
    validity), through K7.  RFC 8032 5.1.3: y < p, a square root of
    (y^2 - 1)/(d y^2 + 1) exists, x = 0 with sign bit 1 is invalid."""
    from ba_tpu_torch.ops.decompress import decompress as k7

    return k7(by.contiguous())


def fixed_base_mult(s_enc: torch.Tensor) -> torch.Tensor:
    """[S]B from 32-byte little-endian scalars [N, 32] -> uint8 [N, 4, 32],
    through K4: S = sum_w d_w 16^w + c 2^256 in signed digits, so [S]B
    folds 65 table entries."""
    from ba_tpu_torch.ops.treeadd import fixed_base_fold

    s_enc = s_enc.contiguous()
    return fixed_base_fold(s_enc, fixed_base_table(s_enc.device))


def compress_point(p: Point) -> torch.Tensor:
    """Point limbs -> 32-byte encodings [..., 32]: the canonical y with the
    low bit of the canonical x in bit 255, 1/Z through ``field.inv``
    (``ba_tpu/crypto/ed25519.py:213``, K8's plain version)."""
    x, y, z, _ = p
    zi = F.inv(z)
    xa = F.canonical(F.mul(x, zi))
    by = F.to_bytes(F.mul(y, zi))
    sign = ((xa[..., 0] & 1) << 7).to(torch.uint8)
    return torch.cat([by[..., :31], by[..., 31:] | sign[..., None]], dim=-1)


def compress(pts: torch.Tensor) -> torch.Tensor:
    """Points uint8 [N, 4, 32] -> 32-byte encodings [N, 32], through K8."""
    from ba_tpu_torch.ops.powchain import compress as k8

    return k8(pts.contiguous())


def clamp_scalar(h32: torch.Tensor) -> torch.Tensor:
    """RFC 8032 5.1.5 clamp of the low digest half -> the secret scalar a:
    clear the 3 low bits, clear bit 255, set bit 254."""
    return torch.cat([h32[..., :1] & 0xF8, h32[..., 1:31], (h32[..., 31:] & 0x3F) | 0x40],
                     dim=-1)


def sign(sk: torch.Tensor, pk: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Batched signing: sk [B, 32], pk [B, 32], msg [B, M] uint8 on one
    device -> sig [B, 64], byte-identical to ``oracle.sign`` lane for lane
    (``ba_tpu/crypto/ed25519.py:407``, term for term).  r is reduced mod L
    before [r]B, which gives the oracle's point and bytes: B generates the
    prime-order subgroup."""
    from ba_tpu_torch.crypto.scalar import muladd_bytes
    from ba_tpu_torch.crypto.sha512 import sha512, sha512_mod_l
    from ba_tpu_torch.ops.modl import reduce_mod_l_planes

    h1 = sha512(sk)
    a = clamp_scalar(h1[:, :32])
    r = sha512_mod_l(torch.cat([h1[:, 32:], msg], dim=-1))
    r_enc = compress(fixed_base_mult(r))
    k = sha512_mod_l(torch.cat([r_enc, pk, msg], dim=-1))
    s = reduce_mod_l_planes(muladd_bytes(k, a, r))
    return torch.cat([r_enc, s], dim=-1)


def batch_point_sum(point: Point) -> Point:
    """Sum points over the leading axis -> a 1-lane Point
    (``ba_tpu/crypto/ed25519.py:290``): identity-padded to the next power
    of two (at least 2), then a halving tree of complete additions, lane i
    of the lower half plus lane i of the upper.  Trailing batch axes are
    summed lane by lane."""
    B = point[0].shape[0]
    size = 1 << max(1, (B - 1).bit_length())
    if size != B:
        ident = identity((size - B, *point[0].shape[1:-1]), point[0].device)
        point = tuple(torch.cat([c, i]) for c, i in zip(point, ident))
    while size > 1:
        half = size // 2
        point = point_add(tuple(c[:half] for c in point), tuple(c[half:] for c in point))
        size = half
    return point


def verify_rlc(pk: torch.Tensor, msg: torch.Tensor, sig: torch.Tensor, z: torch.Tensor,
               pk_group: int = 1):
    """Random-linear-combination batch verification of B signatures
    (``ba_tpu/crypto/ed25519.py:314``): pk [B, 32], msg [B, M], sig
    [B, 64], z [B, 16] uint8 coefficients on one device ->
    ``(batch_ok, enc_ok)``, a bool scalar and bool [B].

    Checks the one cofactored equation

        [8][sum z_i S_i mod L]B == [8](sum [z_i]R_i + sum_j [W_j]A_j),
        W_j = sum over group j of z_i h_i mod L,

    where ``pk_group`` consecutive lanes share a public key, which ladders
    once (``pk[::pk_group]``).  Lanes whose encodings fail (A, R or
    S >= L; ``enc_ok``, exact) get z = 0, and [0]P is the identity.  The
    reference's semantics: all valid gives True; a lane with a
    prime-order defect gives False except with probability ~2^-128 over
    z; a signer's own torsion-malleated signature, which ``verify``
    rejects, is accepted (both sides are multiplied by the cofactor).

    The reference doubles each side three times and compares
    projectively.  Here the right side, [8](sum [z_i]R_i + sum [W_j]A_j),
    is one K3' launch (``window_mult_sum8``: both products, both sums and
    the three doublings); the left side is [8c]B from K4, the same point
    as [8]([c]B) since B has order L (8c < 2^256, its 32 bytes c shifted
    by three bits); the two compressed encodings (K8) are compared, which
    is the same test: an encoding names one point.  Nothing here waits
    for the card."""
    from ba_tpu_torch.crypto.scalar import mul_bytes, sum_bytes
    from ba_tpu_torch.crypto.sha512 import sha512_mod_l
    from ba_tpu_torch.ops.ladder import window_mult_sum8
    from ba_tpu_torch.ops.modl import reduce_mod_l_planes as reduce

    B = pk.shape[0]
    if pk_group < 1 or B % pk_group:
        raise ValueError(f"{B} lanes do not split into groups of {pk_group}")
    K = B // pk_group
    r_enc = sig[:, :32]
    s_enc = sig[:, 32:].contiguous()
    pts, oks = decompress(torch.cat([pk[::pk_group], r_enc]))
    ok_a = oks[:K, None].expand(K, pk_group).reshape(B)
    enc_ok = ok_a & oks[K:] & _lt_const(s_enc, L)
    z = torch.where(enc_ok[:, None], z, torch.zeros_like(z))
    h = sha512_mod_l(torch.cat([r_enc, pk, msg], dim=-1))
    w = reduce(sum_bytes(reduce(mul_bytes(h, z)).reshape(K, pk_group, 32)))
    c = reduce(sum_bytes(reduce(mul_bytes(s_enc, z))[None]))
    right = window_mult_sum8(pts[K:], z, pts[:K], w)
    c = c.to(torch.int32)
    c8 = ((c << 3) & 0xFF) | torch.nn.functional.pad(c[:, :-1] >> 5, (1, 0))
    left = fixed_base_mult(c8.to(torch.uint8))
    enc = compress(torch.cat([left, right]))
    return (enc[0] == enc[1]).all() & enc_ok.all(), enc_ok


def verify(pk: torch.Tensor, msg: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """Batched verify: pk [B, 32], msg [B, M], sig [B, 64] uint8 on one
    device -> bool [B], the oracle's verdict lane for lane."""
    from ba_tpu_torch.crypto.sha512 import sha512_mod_l
    from ba_tpu_torch.ops.ladder import window_verify

    B = pk.shape[0]
    r_enc = sig[:, :32]
    s_enc = sig[:, 32:].contiguous()
    pts, oks = decompress(torch.cat([pk, r_enc]))
    ok_s = _lt_const(s_enc, L)
    left = fixed_base_mult(s_enc)
    h = sha512_mod_l(torch.cat([r_enc, pk, msg], dim=-1))
    return oks[:B] & oks[B:] & ok_s & window_verify(pts[:B], h, pts[B:], left)
