"""K4, the fixed-base product [S]B (``csrc/treeadd.cu``), and its plain
torch version.

K4 replaces ``ba_tpu/ops/treeadd.py::_tree8_kernel`` (the Pallas TPU
kernel: the 64-way point fold of ``fold64_planes``, two levels of an
8-to-1 tree) and the one-hot gather of the window points, which the
reference runs in XLA (``ba_tpu/crypto/ed25519.py:162-192``).  Here the
kernel gathers from the window table itself, so its boundary, and the
plain version's, is the scalar:

    s uint8 [S, 32], table int32 [65, 8, 32]  ->  uint8 [S, 4, 32]

The table is ``crypto/ed25519.fixed_base_table(device)``: [j 16^w]B for
j = 1..8 in the cached form (Y - X, Y + X, 2d T) at Z = 1, in the
kernels' limbs, and a 65th row for the carry out of the top window.  S
is recoded into signed 4-bit digits (``ladder.signed_digits``); group g
of 8 windows is summed in window order (group 7 then adds the carry's
row), and a balanced tree of complete additions folds the 8 partials, the
reference's second level.  The output point's coordinates are canonical
and agree with the kernel's for every thread count; against the
reference, whose fold is another, the result is the same group element
in another projective representation (compare with ``point_eq``).

:func:`fixed_base_fold` runs the plain version on a CPU tensor and
launches K4 on a CUDA one, or raises; it keeps a plain integer
``launches`` count.  The kernel runs :func:`threads_per_lane` threads a
lane (one to eight, fewer as S grows, so the grid fills the card).
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.crypto import ed25519 as E
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import _build
from ba_tpu_torch.ops.ladder import signed_digits

SOURCE = "treeadd.cu"
GROUPS = 8  # the tree's leaves, 8 windows each (FB_GROUPS in the source)
THREADS = (1, 2, 4, 8)  # the thread counts a lane the kernel is built for
TABLE_SHAPE = (E.FB_ROWS, E.FB_ENTRIES, E.FB_ENTRY_WORDS)
# Threads a lane by S: the first (lanes below, threads) that fits, else 1.
# Measured on an H100 (scripts/k4k7_variants.py) at the paths' four lane
# counts only: 8 at one lane, 2 at 10 240, 4 at 20 480 and 1 at 65 536
# (config #3's S) were the fastest.  The cut-offs between those counts
# (4 096, 16 384, 32 768) are not measured; every T gives the same bits.
THREADS_BY_LANES = ((4096, 8), (16384, 2), (32768, 4))


def threads_per_lane(S: int) -> int:
    """The kernel's threads a lane at S lanes."""
    for below, t in THREADS_BY_LANES:
        if S < below:
            return t
    return 1


def _plain_limbs(words: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of the kernels' radix, int32 [..., 10], -> the plain
    field's limbs [..., 22]: the limbs' bits laid end to end are the
    value's 255 bits."""
    dev = words.device
    bits = torch.cat([(words[..., i:i + 1] >> torch.arange(26 - (i & 1), device=dev)) & 1
                      for i in range(10)], dim=-1)
    bits = torch.nn.functional.pad(bits, (0, F.BITS * F.LIMBS - bits.shape[-1]))
    grouped = bits.reshape(*bits.shape[:-1], F.LIMBS, F.BITS)
    return (grouped << torch.arange(F.BITS, device=dev)).sum(dim=-1).to(torch.int32)


def plain_fixed_base_fold(s_enc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: the signed digits' entries (the identity
    for 0, Y - X and Y + X swapped and 2d T negated below 0), each group
    of 8 windows summed in order from its first entry, the carry's entry
    added to group 7, then the tree over the 8 partials."""
    S, dev = s_enc.shape[0], s_enc.device
    carry, dig = signed_digits(s_enc, 4)
    dig = torch.cat([dig, carry[:, None]], dim=1)  # [S, 65]
    coords = [_plain_limbs(table[..., 10 * c:10 * c + 10]) for c in range(3)]
    rows = torch.arange(E.FB_ROWS, device=dev)[None, :]
    idx = (dig.abs() - 1).clamp(min=0)
    ymx, ypx, t2d = (c[rows, idx] for c in coords)  # [S, 65, 22]
    neg, zero = (dig < 0)[..., None], (dig == 0)[..., None]
    one = F.constant(1, dev)
    ymx, ypx = (torch.where(zero, one, torch.where(neg, b, a))
                for a, b in ((ymx, ypx), (ypx, ymx)))
    t2d = torch.where(zero, 0, torch.where(neg, -t2d, t2d))

    def entry(w):  # window w of every group: [S, 8, 22] each
        cols = slice(w, 64, 8) if w < 8 else slice(64, 65)
        return tuple(c[:, cols] for c in (ymx, ypx, t2d))

    acc = E.point_add_cached(E.identity((S, GROUPS), dev), entry(0))
    for j in range(1, 8):
        acc = E.point_add_cached(acc, entry(j))
    last = E.point_add_cached(tuple(c[:, 7:] for c in acc), entry(8))
    acc = tuple(torch.cat([c[:, :7], lc], dim=1) for c, lc in zip(acc, last))
    while acc[0].shape[1] > 1:
        acc = E.point_add(tuple(c[:, 0::2] for c in acc), tuple(c[:, 1::2] for c in acc))
    return E.encode_point(tuple(c[:, 0] for c in acc))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_fixed_base
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def fixed_base_fold(s_enc: torch.Tensor, table: torch.Tensor,
                    threads: int | None = None) -> torch.Tensor:
    """[S]B for S scalars: s_enc uint8 [S, 32], the window table int32
    [65, 8, 32] on the same device -> uint8 [S, 4, 32].  ``threads`` (1,
    2, 4 or 8) overrides :func:`threads_per_lane` on the card; the result
    is the same."""
    dev = s_enc.device
    if s_enc.dim() != 2 or s_enc.shape[1] != 32:
        raise ValueError(f"s_enc must be [S, 32], got {tuple(s_enc.shape)}")
    n = s_enc.shape[0]
    threads = threads_per_lane(n) if threads is None else threads
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}, got {threads}")
    if dev.type == "cpu":
        return plain_fixed_base_fold(s_enc, table.to(dev))
    if dev.type != "cuda":
        raise ValueError(f"the fixed-base kernel runs on a CUDA device, not {dev}")
    _build.check_tensor(s_enc, "s_enc", torch.uint8, (n, 32), dev)
    _build.check_tensor(table, "table", torch.int32, TABLE_SHAPE, dev)
    out = torch.empty((n, 4, 32), dtype=torch.uint8, device=dev)
    err = _lib().ba_fixed_base(n, threads, s_enc.data_ptr(), table.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fixed-base launch failed: CUDA error {err}")
    if n:
        fixed_base_fold.launches += 1
    return out


fixed_base_fold.launches = 0


def reset_launches() -> None:
    fixed_base_fold.launches = 0
