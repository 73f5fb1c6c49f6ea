"""Pure-Python Ed25519 oracle (RFC 8032): the ground truth for the port's
native signer (``ba_tpu_torch/native``).

The port's own copy of ``ba_tpu/crypto/oracle.py``: Python bigints and
hashlib SHA-512, deliberately slow and obvious — correctness only.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19  # field prime
L = 2**252 + 27742317777372353535851937790883648493  # group order


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


D = (-121665 * _inv(121666)) % P  # Edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)


def _xrecover(y: int) -> int:
    """Recover even x with x^2 = (y^2-1)/(d y^2+1); RFC 8032 section 5.1.3."""
    xx = (y * y - 1) * _inv(D * y * y + 1) % P
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - xx) % P != 0:
        raise ValueError("not a square: point not on curve")
    if x % 2 != 0:
        x = P - x
    return x


B_Y = 4 * _inv(5) % P
B_X = _xrecover(B_Y)
BASE = (B_X, B_Y)


def edwards_add(p: tuple, q: tuple) -> tuple:
    x1, y1 = p
    x2, y2 = q
    k = D * x1 * x2 * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * _inv(1 + k) % P
    y3 = (y1 * y2 + x1 * x2) * _inv(1 - k) % P
    return (x3, y3)


def scalarmult(p: tuple, e: int) -> tuple:
    q = (0, 1)
    while e > 0:
        if e & 1:
            q = edwards_add(q, p)
        p = edwards_add(p, p)
        e >>= 1
    return q


def encode_point(p: tuple) -> bytes:
    x, y = p
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decode_point(s: bytes) -> tuple:
    y_full = int.from_bytes(s, "little")
    sign = y_full >> 255
    y = y_full & ((1 << 255) - 1)
    if y >= P:
        raise ValueError("y out of range")
    x = _xrecover(y)
    if x == 0 and sign == 1:
        # RFC 8032 5.1.3 step 4: the only square root of 0 is 0, whose
        # encoding must carry sign bit 0 (P - 0 would be non-canonical).
        raise ValueError("non-canonical x=0 encoding")
    if x & 1 != sign:
        x = P - x
    return (x, y)


def _hint(m: bytes) -> int:
    return int.from_bytes(hashlib.sha512(m).digest(), "little")


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def publickey(sk: bytes) -> bytes:
    """32-byte public key from a 32-byte secret seed (RFC 8032 5.1.5)."""
    h = hashlib.sha512(sk).digest()
    a = _clamp(h[:32])
    return encode_point(scalarmult(BASE, a))


def sign(sk: bytes, pk: bytes, msg: bytes) -> bytes:
    """64-byte signature R || S (RFC 8032 5.1.6)."""
    h = hashlib.sha512(sk).digest()
    a = _clamp(h[:32])
    r = _hint(h[32:] + msg)
    R = scalarmult(BASE, r)
    r_enc = encode_point(R)
    s = (r + _hint(r_enc + pk + msg) * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Check [S]B == R + [h]A (RFC 8032 5.1.7, no cofactor multiplication —
    the same equation the native verifier evaluates).

    h is reduced mod L before the multiply, matching ref10/libsodium (and
    the native verifier).  For honest keys
    the reduction is invisible — A and R have order L — it only pins down
    the accept set for adversarial points with a torsion component."""
    if len(sig) != 64 or len(pk) != 32:
        return False
    try:
        R = decode_point(sig[:32])
        A = decode_point(pk)
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = _hint(sig[:32] + pk + msg) % L
    left = scalarmult(BASE, s)
    right = edwards_add(R, scalarmult(A, h))
    return left == right


def secret_from_seed(seed: bytes) -> bytes:
    """Deterministic 32-byte secret key from an arbitrary seed — the single
    derivation shared by :func:`keypair` and the batch host signer
    (ba_tpu_torch.crypto.signed.commander_keys)."""
    return hashlib.sha512(b"ba_tpu-key:" + seed).digest()[:32]


def keypair(seed: bytes) -> tuple[bytes, bytes]:
    """Deterministic (sk, pk) so fixtures are reproducible from small
    integer seeds."""
    sk = secret_from_seed(seed)
    return sk, publickey(sk)
