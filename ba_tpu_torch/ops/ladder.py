"""K3, the verification tail (``csrc/window_verify.cu``), K3', the
signed-window multiply and the batch verifier's right side
(``csrc/window_mult.cu``), and K3'', the double-and-add ladder
(``csrc/scalar_mult.cu``), with their plain torch versions.

K3 and K3' run one accumulator, ``window_acc`` in ``csrc/window.cuh``,
the Hopper design of ``ba_tpu/ops/ladder.py::_window_acc``: per lane the
multiples [1..4]P (3 additions), then k recoded into signed 3-bit digits
in [-4, 4) (:func:`signed_digits`: k plus 4 in every window, each window
less 4, the carry out of the top one more digit, 0 or 1, with which the
sum starts), then one window a digit, most significant first, each three
doublings (T only on the third) and one addition of [|d|]P, negated for
d < 0, the identity for d = 0.  A warp (FOLD consecutive lanes) whose
lanes all hold one point, as BASELINE config #3's lanes hold a commander
key 64 times, runs signed 4-bit windows on one table of [1..8]P for the
warp instead (:func:`warp_point_lanes`); K3 and K3''s per-lane kernel
launch one instance for each kind of warp a call.  Points are canonical
encodings (``crypto/ed25519.encode_point``).  :func:`plain_lane_acc` is
the same chains in torch, so the encodings are equal.

K3 replaces ``_window_verify_kernel`` (the Pallas TPU kernel): [h]A, then
R + [h]A and the cross-multiplied equality with [S]B:

    a, r uint8 [S, 4, 32], h uint8 [S, 32], left uint8 [S, 4, 32]  ->  bool [S]

K3' replaces ``_window_kernel`` (through ``window_mult``).
:func:`window_mult` is [k]P a lane, for a 32-byte k on the card (the
ladder leg; the plain version takes any width):

    point uint8 [S, 4, 32], k uint8 [S, nbytes]  ->  uint8 [S, 4, 32]

:func:`window_mult_sum8` is the batch verifier's right side in one
launch, [8](sum_i [z_i]R_i + sum_j [w_j]A_j), where the reference runs
``window_mult`` twice, ``ed25519.batch_point_sum`` twice, an addition and
three doublings:

    r uint8 [nz, 4, 32], z uint8 [nz, 16], a uint8 [na, 4, 32],
    w uint8 [na, 32]  ->  uint8 [1, 4, 32]

Each block of FOLD lanes (the A set's blocks first, then the R set's,
each set's last block padded with the identity) is summed by a halving
tree, lane i plus lane i + 16, then + 8, ..., as ``batch_point_sum``
pairs 32 points; the block sums are paired level by level, node 2i + 1
added to node 2i and an odd last node passed up; the root is doubled
three times.  :func:`fold_points` is that pairing in torch.

K3'' (``csrc/scalar_mult.cu``) replaces ``_ladder_kernel`` (``:53``,
through ``scalar_mult`` ``:205``, exported as
``ba_tpu.ops.ladder_scalar_mult``): [k]P by double-and-add-always, two
complete additions a bit and a select, LSB first, with the reference's
projective coordinates (q + q by the unified addition), so the canonical
X, Y, Z and T equal ``ed25519.scalar_mult``'s.  Two threads a lane run
the two chains in step (q's and acc's, q_t passed across by shuffles):

    point uint8 [S, 4, 32], bits [S, nbits] 0/1 (nbits a multiple of 32)
        ->  uint8 [S, 4, 32]

:func:`window_verify`, :func:`window_mult`, :func:`window_mult_sum8` and
:func:`scalar_mult` run the plain version on a CPU tensor and launch the
kernel on a CUDA one, or raise; each keeps a plain integer ``launches``
count.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build

SOURCE = "window_verify.cu"
MULT_SOURCE = "window_mult.cu"
LADDER_SOURCE = "scalar_mult.cu"
FOLD = 32  # lanes a block of K3' sums (one warp)
WINDOW_BITS = 3  # the signed windows of window.cuh (WINDOW_BITS there)
WARP_WINDOW_BITS = 4  # a warp with one point: its one table (WARP_WINDOW_BITS there)
K3P_BYTES = 32  # the k width K3''s per-lane kernel is built for
SUM_BYTES = (16, 32)  # the sum's k widths: z of its R set, w of its A set
GE_INT32 = 40  # a point in the kernels' radix: 4 x 10 int32 limbs


def signed_digits(k: torch.Tensor, W: int = WINDOW_BITS) -> tuple:
    """The recoding of window.cuh: k uint8 [S, nbytes] -> (the carry digit
    int64 [S], 0 or 1, and the digits int64 [S, nwin], least significant
    first, in [-2^(W-1), 2^(W-1))), nwin = ceil(8 nbytes / W): k = sum_i
    d_i 2^(W i) + carry 2^(W nwin)."""
    S, nbytes = k.shape
    nwin = -(-8 * nbytes // W)
    shifts = torch.arange(8, device=k.device)
    bits = ((k.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(S, 8 * nbytes)
    bits = torch.nn.functional.pad(bits, (0, nwin * W - 8 * nbytes))
    groups = (bits.reshape(S, nwin, W) << torch.arange(W, device=k.device)).sum(-1)
    carry = torch.zeros(S, dtype=torch.int64, device=k.device)
    out = []
    for i in range(nwin):
        v = groups[:, i] + carry
        carry = (v >= 1 << (W - 1)).to(torch.int64)
        out.append(v - (carry << W))
    return carry, torch.stack(out, dim=1)


def plain_window_acc(point: E.Point, k: torch.Tensor, W: int = WINDOW_BITS) -> E.Point:
    """[k]P a lane by signed windows of W bits, the accumulator K3 and K3'
    share: point limbs (4 x [S, 22]), k uint8 [S, nbytes] -> point limbs."""
    S = k.shape[0]
    dev = k.device
    point = tuple(c.expand(S, F.LIMBS) for c in point)
    table = [E.identity((S,), dev), point]
    for _ in range(2, (1 << (W - 1)) + 1):
        table.append(E.point_add(table[-1], point))
    table = tuple(torch.stack([t[c] for t in table], dim=1) for c in range(4))  # [j]P a lane
    lanes = torch.arange(S, device=dev)
    top, dig = signed_digits(k, W)
    acc = E.point_select(top == 1, point, E.identity((S,), dev))
    zero = F.zeros((S,), dev)
    for w in range(dig.shape[1] - 1, -1, -1):
        for i in range(W):
            acc = E.point_dbl(acc, with_t=i == W - 1)
        d = dig[:, w]
        x, y, z, t = (c[lanes, d.abs()] for c in table)
        neg = (d < 0)[:, None]
        entry = (torch.where(neg, F.sub(zero, x), x), y, z,
                 torch.where(neg, F.sub(zero, t), t))
        acc = E.point_add(acc, entry)
    return acc


def warp_point_lanes(point: torch.Tensor) -> torch.Tensor:
    """bool [S]: the lanes of point uint8 [S, 4, 32] whose warp (FOLD
    consecutive lanes, the last cut at S) holds one encoding in every
    lane, the kernels' test for the warp's one table (window.cuh)."""
    S = point.shape[0]
    lead = point[torch.arange(S, device=point.device) // FOLD * FOLD]
    same = (point == lead).reshape(S, -1).all(dim=1)
    G = -(-S // FOLD)
    same = torch.cat([same, same.new_ones(G * FOLD - S)])
    return same.reshape(G, FOLD).all(dim=1).repeat_interleave(FOLD)[:S]


def plain_lane_acc(point: torch.Tensor, k: torch.Tensor) -> E.Point:
    """K3's and K3''s per-lane products: point uint8 [S, 4, 32], k uint8
    [S, nbytes] -> point limbs; a warp with one point runs signed windows
    of WARP_WINDOW_BITS, any other WINDOW_BITS, as the kernels do."""
    limbs = E.decode_point(point)
    warp = warp_point_lanes(point)
    out = tuple(torch.empty_like(c) for c in limbs)
    for lanes, W in ((warp, WARP_WINDOW_BITS), (~warp, WINDOW_BITS)):
        idx = lanes.nonzero().squeeze(1)
        if idx.numel():
            acc = plain_window_acc(tuple(c[idx] for c in limbs), k[idx], W)
            for o, a in zip(out, acc):
                o[idx] = a
    return out


def _pad_identity(p: E.Point, size: int) -> E.Point:
    extra = size - p[0].shape[0]
    if not extra:
        return p
    ident = E.identity((extra,), p[0].device)
    return tuple(torch.cat([c, i]) for c, i in zip(p, ident))


def fold_points(p: E.Point) -> E.Point:
    """The sum's pairing over S points (4 x [S, 22], S >= 1): blocks of
    FOLD, the last padded with the identity, each summed by the halving
    tree; then the block sums level by level, node 2i + 1 added to node
    2i and an odd last node passed up -> 4 x [1, 22]."""
    G = -(-p[0].shape[0] // FOLD)
    p = _pad_identity(p, G * FOLD)
    nodes = tuple(c[0] for c in E.batch_point_sum(
        tuple(c.reshape(G, FOLD, F.LIMBS).transpose(0, 1) for c in p)))
    while G > 1:
        pairs = G // 2
        summed = E.point_add(tuple(c[0:2 * pairs:2] for c in nodes),
                             tuple(c[1:2 * pairs:2] for c in nodes))
        nodes = tuple(torch.cat([s, c[2 * pairs:]]) for s, c in zip(summed, nodes))
        G = nodes[0].shape[0]
    return nodes


def plain_window_mult(point: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version of K3''s per-lane kernel, batched over lanes."""
    return E.encode_point(plain_lane_acc(point, k))


def plain_window_mult_sum8(r: torch.Tensor, z: torch.Tensor, a: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """The plain version of K3''s sum: each set's products padded to
    blocks of FOLD, the A set's first, summed in the kernel's pairing
    (:func:`fold_points`), then three doublings."""
    sets = []
    for pts, k in ((a, w), (r, z)):
        if pts.shape[0]:
            acc = plain_window_acc(E.decode_point(pts), k)
            sets.append(_pad_identity(acc, -(-pts.shape[0] // FOLD) * FOLD))
    total = fold_points(tuple(torch.cat(c) for c in zip(*sets)))
    for i in range(3):
        total = E.point_dbl(total, with_t=i == 2)
    return E.encode_point(total)


def plain_window_verify(a: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                        left: torch.Tensor) -> torch.Tensor:
    """The plain version of K3, the kernel's steps batched over lanes."""
    acc = plain_lane_acc(a, h)
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
        lib.ba_window_mult.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        lib.ba_window_mult.restype = ctypes.c_int
        lib.ba_window_mult_sum8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2) * 2 + \
            [ctypes.c_void_p] * 4
        lib.ba_window_mult_sum8.restype = ctypes.c_int
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


def window_mult(point: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[k]P per lane: point uint8 [S, 4, 32], k uint8 [S, nbytes] -> uint8
    [S, 4, 32].  On a CUDA tensor nbytes must be K3P_BYTES (the kernel is
    built for it alone); on a CPU tensor the plain version takes any."""
    dev = point.device
    if point.dim() != 3 or tuple(point.shape[1:]) != (4, 32):
        raise ValueError(f"point must be [S, 4, 32], got {tuple(point.shape)}")
    if k.dim() != 2 or k.shape[0] != point.shape[0] or k.shape[1] < 1:
        raise ValueError(f"k must be [{point.shape[0]}, nbytes >= 1], got {tuple(k.shape)}")
    if dev.type == "cpu":
        return plain_window_mult(point, k)
    if dev.type != "cuda":
        raise ValueError(f"the window-multiply kernel runs on a CUDA device, not {dev}")
    n = point.shape[0]
    if k.shape[1] != K3P_BYTES:
        raise ValueError(f"the window-multiply kernel is built for a k of {K3P_BYTES} "
                         f"bytes, got {k.shape[1]}")
    _build.check_tensor(point, "point", torch.uint8, (n, 4, 32), dev)
    _build.check_tensor(k, "k", torch.uint8, (n, K3P_BYTES), dev)
    out = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
    err = _mult_lib().ba_window_mult(n, point.data_ptr(), k.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-multiply launch failed: CUDA error {err}")
    if n:
        window_mult.launches += 1
    return out


def window_mult_sum8(r: torch.Tensor, z: torch.Tensor, a: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """[8](sum_i [z_i]R_i + sum_j [w_j]A_j), the batch verifier's right
    side: r uint8 [nz, 4, 32], z uint8 [nz, 16], a uint8 [na, 4, 32], w
    uint8 [na, 32] on one device, nz + na >= 1 -> uint8 [1, 4, 32]."""
    dev = r.device
    nz, na = r.shape[0], a.shape[0]
    specs = (("r", r, (nz, 4, 32)), ("z", z, (nz, SUM_BYTES[0])), ("a", a, (na, 4, 32)),
             ("w", w, (na, SUM_BYTES[1])))
    for name, t, shape in specs:
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got {tuple(t.shape)} "
                             f"on {t.device}")
    if nz + na == 0:
        raise ValueError("the sum needs at least one lane")
    if dev.type == "cpu":
        return plain_window_mult_sum8(r, z, a, w)
    if dev.type != "cuda":
        raise ValueError(f"the window-multiply kernel runs on a CUDA device, not {dev}")
    for name, t, shape in specs:
        _build.check_tensor(t, name, torch.uint8, shape, dev)
    G = -(-na // FOLD) + -(-nz // FOLD)
    nodes = torch.empty((2 * G, GE_INT32), dtype=torch.int32, device=dev)
    counts = torch.zeros((G,), dtype=torch.int32, device=dev)
    out = torch.empty((1, 4, 32), dtype=torch.uint8, device=dev)
    err = _mult_lib().ba_window_mult_sum8(
        na, a.data_ptr(), w.data_ptr(), nz, r.data_ptr(), z.data_ptr(), nodes.data_ptr(),
        counts.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-multiply-sum launch failed: CUDA error {err}")
    window_mult_sum8.launches += 1
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
window_mult_sum8.launches = 0
scalar_mult.launches = 0


def reset_launches() -> None:
    window_verify.launches = 0
    window_mult.launches = 0
    window_mult_sum8.launches = 0
    scalar_mult.launches = 0
