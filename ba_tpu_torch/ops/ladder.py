"""K3, the verification tail (``csrc/window_verify.cu``), K3', the 4-bit
window multiply (``csrc/window_mult.cu``), and K3'', the double-and-add
ladder (``csrc/scalar_mult.cu``), with their plain torch versions.

K3 and K3' run one accumulator, ``window_acc`` in ``csrc/window.cuh``, the
body of ``ba_tpu/ops/ladder.py::_window_acc``: per lane the 16 multiples
[j]P (14 additions), then one window a digit of k, most significant
first, each four doublings (T only on the fourth) and one addition from
the table.  The digit of window w is nibble w of the little-endian
scalar, the reference's ``(word >> 4 * (w & 7)) & 15`` of its packed
bits.  Points are canonical encodings (``crypto/ed25519.encode_point``).

K3 replaces ``_window_verify_kernel`` (the Pallas TPU kernel): [h]A, then
R + [h]A and the cross-multiplied equality with [S]B:

    a, r uint8 [S, 4, 32], h uint8 [S, 32], left uint8 [S, 4, 32]  ->  bool [S]

K3' replaces ``_window_kernel`` (through ``window_mult``): [k]P a lane,
for k of the byte widths in ``K3P_LENGTHS`` (1 byte for the batch
verifier's cofactor 8, 16 for its [z]R, 32 for [W]A and the ladder leg;
the kernel has one instance a width, with the window loop's trip count
fixed at compile time; the plain version takes any width):

    point uint8 [S, 4, 32], k uint8 [S, nbytes]  ->  uint8 [S, 4, 32]

With ``fold=True`` K3' also sums its products, which the reference does
in XLA (``ed25519.batch_point_sum``), and returns one point, uint8
[1, 4, 32]: each block of FOLD lanes (the last padded with the identity)
is summed by a halving tree, lane i plus lane i + 16, then + 8, ..., as
``batch_point_sum`` pairs 32 points; column t of the block sums (sums t,
t + 32, t + 64, ... added in turn to the identity) and a last halving
tree give the total.  :func:`fold_points` is that pairing in torch, so
the plain version's encodings equal the kernel's.

K3'' (``csrc/scalar_mult.cu``) replaces ``_ladder_kernel`` (``:53``,
through ``scalar_mult`` ``:205``, exported as
``ba_tpu.ops.ladder_scalar_mult``): [k]P by double-and-add-always, two
complete additions a bit and a select, LSB first, with the reference's
projective coordinates (q + q by the unified addition), so the canonical
X, Y, Z and T equal ``ed25519.scalar_mult``'s:

    point uint8 [S, 4, 32], bits [S, nbits] 0/1 (nbits a multiple of 32)
        ->  uint8 [S, 4, 32]

:func:`window_verify`, :func:`window_mult` and :func:`scalar_mult` run
the plain version on a CPU tensor and launch the kernel on a CUDA one, or
raise; each keeps a plain integer ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build
from ba_tpu_torch.ops.treeadd import digits

SOURCE = "window_verify.cu"
MULT_SOURCE = "window_mult.cu"
LADDER_SOURCE = "scalar_mult.cu"
FOLD = 32  # lanes a block of K3' sums (one warp)
K3P_LENGTHS = (1, 16, 32)  # the k widths in bytes K3' is built for (window_mult.cu)
GE_INT32 = 40  # a point in the kernels' radix: 4 x 10 int32 limbs


def plain_window_acc(point: E.Point, k: torch.Tensor) -> E.Point:
    """[k]P a lane by 4-bit windows, the accumulator K3 and K3' share:
    point limbs (4 x [S, 22]), k uint8 [S, nbytes] -> point limbs."""
    S = k.shape[0]
    dev = k.device
    table = [E.identity((S,), dev), point]
    for _ in range(2, 16):
        table.append(E.point_add(table[-1], point))
    table = tuple(torch.stack([t[c].expand(S, F.LIMBS) for t in table], dim=1)
                  for c in range(4))  # 4 x [S, 16, 22]
    lanes = torch.arange(S, device=dev)
    dig = digits(k)
    acc = E.identity((S,), dev)
    for w in range(dig.shape[1] - 1, -1, -1):
        for i in range(4):
            acc = E.point_dbl(acc, with_t=i == 3)
        acc = E.point_add(acc, tuple(c[lanes, dig[:, w]] for c in table))
    return acc


def _pad_identity(p: E.Point, size: int) -> E.Point:
    extra = size - p[0].shape[0]
    if not extra:
        return p
    ident = E.identity((extra,), p[0].device)
    return tuple(torch.cat([c, i]) for c, i in zip(p, ident))


def fold_points(p: E.Point) -> E.Point:
    """K3''s sum of its S products, in the kernel's pairing: point limbs
    (4 x [S, 22]) -> 4 x [1, 22]."""
    G = -(-p[0].shape[0] // FOLD)
    p = _pad_identity(p, G * FOLD)
    parts = E.batch_point_sum(tuple(c.reshape(G, FOLD, F.LIMBS).transpose(0, 1) for c in p))
    C = -(-G // FOLD)
    parts = _pad_identity(tuple(c[0] for c in parts), C * FOLD)
    cols = tuple(c.reshape(C, FOLD, F.LIMBS) for c in parts)
    total = E.identity((FOLD,), p[0].device)
    for row in range(C):
        total = E.point_add(total, tuple(c[row] for c in cols))
    return E.batch_point_sum(total)


def plain_window_mult(point: torch.Tensor, k: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """The plain version of K3': the kernel's steps batched over lanes."""
    acc = plain_window_acc(E.decode_point(point), k)
    return E.encode_point(fold_points(acc) if fold else acc)


def plain_window_verify(a: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                        left: torch.Tensor) -> torch.Tensor:
    """The plain version of K3, the kernel's steps batched over lanes."""
    acc = plain_window_acc(E.decode_point(a), h)
    xr, yr, zr, _ = E.point_add(E.decode_point(r), acc)
    xl, yl, zl, _ = E.decode_point(left)
    return F.eq(F.mul(xl, zr), F.mul(xr, zl)) & F.eq(F.mul(yl, zr), F.mul(yr, zl))


def plain_scalar_mult(point: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The plain version of K3'': ``ed25519.ladder`` (the reference's
    double-and-add loop) on the decoded points, encoded."""
    return E.encode_point(E.ladder(E.decode_point(point), bits))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[S, nbits] 0/1 -> int32 [nbits / 32, S]: bit t of lane i at bit
    t % 32 of word [t / 32, i] (``ba_tpu/ops/ladder.py:173 _pack_bits``'s
    layout, untiled), made on the bits' device without a host sync."""
    S, nbits = bits.shape
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = ((bits == 1).to(torch.int64).reshape(S, nbits // 32, 32) << shifts).sum(dim=-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # as int32
    return words.to(torch.int32).t().contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_window_verify
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return lib


def _mult_lib() -> ctypes.CDLL:
    lib = _build.load(MULT_SOURCE)
    if lib.ba_window_mult.argtypes is None:
        lib.ba_window_mult.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        lib.ba_window_mult.restype = ctypes.c_int
        lib.ba_window_mult_fold.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
        lib.ba_window_mult_fold.restype = ctypes.c_int
    return lib


def _ladder_lib() -> ctypes.CDLL:
    lib = _build.load(LADDER_SOURCE)
    if lib.ba_scalar_mult.argtypes is None:
        lib.ba_scalar_mult.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        lib.ba_scalar_mult.restype = ctypes.c_int
    return lib


def window_verify(a: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                  left: torch.Tensor) -> torch.Tensor:
    """``left == r + [h]a`` per lane -> bool [S]."""
    dev = a.device
    if a.dim() != 3 or tuple(a.shape[1:]) != (4, 32):
        raise ValueError(f"a must be [S, 4, 32], got {tuple(a.shape)}")
    if dev.type == "cpu":
        return plain_window_verify(a, h, r, left)
    if dev.type != "cuda":
        raise ValueError(f"the window-verify kernel runs on a CUDA device, not {dev}")
    n = a.shape[0]
    for name, t, shape in (("a", a, (n, 4, 32)), ("h", h, (n, 32)), ("r", r, (n, 4, 32)),
                           ("left", left, (n, 4, 32))):
        _build.check_tensor(t, name, torch.uint8, shape, dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = _lib().ba_window_verify(n, a.data_ptr(), h.data_ptr(), r.data_ptr(), left.data_ptr(),
                                  ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-verify launch failed: CUDA error {err}")
    if n:
        window_verify.launches += 1
    return ok


def window_mult(point: torch.Tensor, k: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """[k]P per lane: point uint8 [S, 4, 32], k uint8 [S, nbytes] -> uint8
    [S, 4, 32]; with ``fold`` their sum, uint8 [1, 4, 32] (S >= 1).

    On a CUDA tensor, nbytes must be one of ``K3P_LENGTHS``: any other
    length raises, as the kernel has no instance for it.  On a CPU tensor
    the plain version takes any length."""
    dev = point.device
    if point.dim() != 3 or tuple(point.shape[1:]) != (4, 32):
        raise ValueError(f"point must be [S, 4, 32], got {tuple(point.shape)}")
    if k.dim() != 2 or k.shape[0] != point.shape[0] or k.shape[1] < 1:
        raise ValueError(f"k must be [{point.shape[0]}, nbytes >= 1], got {tuple(k.shape)}")
    n, nbytes = k.shape
    if fold and n == 0:
        raise ValueError("fold needs at least one lane")
    if dev.type == "cpu":
        return plain_window_mult(point, k, fold)
    if dev.type != "cuda":
        raise ValueError(f"the window-multiply kernel runs on a CUDA device, not {dev}")
    if nbytes not in K3P_LENGTHS:
        raise ValueError(f"the window-multiply kernel is built for k of {K3P_LENGTHS} "
                         f"bytes, got {nbytes}")
    _build.check_tensor(point, "point", torch.uint8, (n, 4, 32), dev)
    _build.check_tensor(k, "k", torch.uint8, (n, nbytes), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if fold:
        out = torch.empty((1, 4, 32), dtype=torch.uint8, device=dev)
        partials = torch.empty((-(-n // FOLD), GE_INT32), dtype=torch.int32, device=dev)
        done = torch.zeros((1,), dtype=torch.int32, device=dev)
        err = _mult_lib().ba_window_mult_fold(n, nbytes, point.data_ptr(), k.data_ptr(),
                                              partials.data_ptr(), done.data_ptr(),
                                              out.data_ptr(), stream)
    else:
        out = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
        err = _mult_lib().ba_window_mult(n, nbytes, point.data_ptr(), k.data_ptr(),
                                         out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"window-multiply launch failed: CUDA error {err}")
    if n:
        window_mult.launches += 1
    return out


def scalar_mult(point: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """[k]P per lane by double-and-add-always: point uint8 [S, 4, 32], bits
    [S, nbits] 0/1, least significant first, nbits a multiple of 32 ->
    uint8 [S, 4, 32]."""
    dev = point.device
    if point.dim() != 3 or tuple(point.shape[1:]) != (4, 32):
        raise ValueError(f"point must be [S, 4, 32], got {tuple(point.shape)}")
    if bits.dim() != 2 or bits.shape[0] != point.shape[0] or bits.shape[1] % 32:
        raise ValueError(f"bits must be [{point.shape[0]}, a multiple of 32], "
                         f"got {tuple(bits.shape)}")
    if dev.type == "cpu":
        return plain_scalar_mult(point, bits)
    if dev.type != "cuda":
        raise ValueError(f"the scalar-mult kernel runs on a CUDA device, not {dev}")
    n, nbits = bits.shape
    _build.check_tensor(point, "point", torch.uint8, (n, 4, 32), dev)
    if bits.device != dev:
        raise ValueError(f"bits: expected on {dev}, got {bits.device}")
    words = pack_bits(bits)
    out = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
    err = _ladder_lib().ba_scalar_mult(n, nbits // 32, point.data_ptr(), words.data_ptr(),
                                       out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scalar-mult launch failed: CUDA error {err}")
    if n:
        scalar_mult.launches += 1
    return out


window_verify.launches = 0
window_mult.launches = 0
scalar_mult.launches = 0


def reset_launches() -> None:
    window_verify.launches = 0
    window_mult.launches = 0
    scalar_mult.launches = 0
