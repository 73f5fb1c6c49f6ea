"""Ed25519 (RFC 8032) on Python integers, and the signed tables' keys and
messages: what the key-set set-up has to produce.

Extended twisted Edwards coordinates as in RFC 8032's section 6 code.
Verification checks [S]B == R + [h]A with h reduced mod L and S < L.

Instance b of a key-set drawn from ``seed`` has the secret key
``sha512(b"ba_tpu-key:" + f"{seed}:{b}")[:32]``; its table holds the
commander's signature on ``order_message(b, v)`` for v = 0 (RETREAT) and
1 (ATTACK).  Nothing here imports the program.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
MSG_LEN = 16


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P)
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


G_Y = 4 * pow(5, P - 2, P) % P
G_X = _recover_x(G_Y, 0)
BASE = (G_X, G_Y, 1, G_X * G_Y % P)


def _add(p, q):
    a = (p[1] - p[0]) * (q[1] - q[0]) % P
    b = (p[1] + p[0]) * (q[1] + q[0]) % P
    c = 2 * p[3] * q[3] * D % P
    d = 2 * p[2] * q[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(s: int, p):
    q = (0, 1, 1, 0)
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _equal(p, q) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and (p[1] * q[2] - q[1] * p[2]) % P == 0


def _compress(p) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x, y = p[0] * zinv % P, p[1] * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(s: bytes):
    y = int.from_bytes(s, "little")
    sign, y = y >> 255, y & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    return None if x is None else (x, y, 1, x * y % P)


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def _secret_scalar(sk: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(sk).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def publickey(sk: bytes) -> bytes:
    return _compress(_mul(_secret_scalar(sk)[0], BASE))


def sign(sk: bytes, pk: bytes, msg: bytes) -> bytes:
    a, prefix = _secret_scalar(sk)
    r = _h(prefix + msg) % L
    r_enc = _compress(_mul(r, BASE))
    s = (r + _h(r_enc + pk + msg) * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pk) != 32:
        return False
    a_pt, r_pt = _decompress(pk), _decompress(sig[:32])
    s = int.from_bytes(sig[32:], "little")
    if a_pt is None or r_pt is None or s >= L:
        return False
    h = _h(sig[:32] + pk + msg) % L
    return _equal(_mul(s, BASE), _add(r_pt, _mul(h, a_pt)))


def secret_key(seed: int, instance: int) -> bytes:
    return hashlib.sha512(b"ba_tpu-key:" + f"{seed}:{instance}".encode()).digest()[:32]


def order_message(instance: int, value: int) -> bytes:
    body = b"BAv1" + int(instance).to_bytes(4, "little") + bytes([value & 0xFF])
    return body.ljust(MSG_LEN, b"\0")
