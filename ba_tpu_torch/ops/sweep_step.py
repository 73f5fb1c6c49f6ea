"""K2, the fused signed-sweep step (``csrc/sweep_step.cu``), and its plain
torch version.

K2 replaces ``ba_tpu/ops/sweep_step.py::_step_kernel`` (the Pallas TPU
kernel): ``rounds`` whole signed, collapsed SM(m) agreement rounds per
launch — the round-1 broadcast, the signature gate from the per-value
table verdicts, m relay rounds, choice, majority counts and the 3f+1
quorum — reading the state once and writing one int8 decision per
(instance, round).

Randomness.  The TPU kernel draws from the TPU's hardware PRNG, which no
other device reproduces; K2 and :func:`plain_fused_signed_sweep_step`
draw from Philox4x32-10 instead, written out in both, so the two are
bit-equal.  The key is (seed as uint32, instance index b), where b is
``index_base`` plus the row (the global index: a shard of a larger batch
draws what the whole batch's launch draws for it), the counter
(round rr, general j, d // 4, 0), and draw d is word d % 4: d = 0 is the
round-1 coin (bit 0), d = r is relay round r (byte 0 gates RETREAT, byte
1 gates ATTACK).  Each draw is fixed by (seed, b, rr, j, d) alone, so
skipping a draw whose value cannot matter (a dead general, an honest
leader's coins, a threshold of 0 or 256) changes nothing.  Against the
JAX composition (``tests/test_ops.py``'s ``_xla_sweep_step``) the
contract is the reference's own: bit-exact where no draw can matter,
equal in distribution otherwise.

:func:`fused_signed_sweep_step` keeps the reference's signature: on a
CPU tensor it runs the plain version; on a CUDA tensor it launches K2 or
raises.  It keeps a plain integer ``launches`` count.
:func:`fused_sharded_sweep_step` is the reference's sharded form on a
device mesh: one call of it a "data" shard, each numbering its instances
from ``shard * B / d``, so every shard count gives the unsharded step's
bits and no (seed, b) pair is drawn by two shards.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.core.quorum import majority_counts, quorum_decision
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED
from ba_tpu_torch.ops import _build

SOURCE = "sweep_step.cu"
MAX_ROUNDS = 1920  # the reference's cap (15 packed rounds x 128 lanes)
MAX_N = 1024  # 32 generals a lane of one warp

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, mult: int):
    """(hi, lo) 32-bit words of ``a * mult`` for uint32 values held in
    int64, through 16-bit halves so no product leaves int64."""
    p_lo = (a & 0xFFFF) * mult
    s = (a >> 16) * mult + (p_lo >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values,
    any broadcastable shapes -> the four output words."""
    words = (c0, c1, c2, c3, k0, k1)
    dev = next((x.device for x in words if isinstance(x, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.int64, device=dev) for x in words))
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & M32
            k1 = (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_rounds(rounds: int) -> None:
    if not 1 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"rounds={rounds} outside [1, {MAX_ROUNDS}]")


def _check_index_base(index_base: int) -> None:
    if not 0 <= index_base < 2**31:
        raise ValueError(f"index_base={index_base} outside [0, 2**31)")


def plain_fused_signed_sweep_step(seed, order, leader, faulty, alive, ok, m: int = 3,
                                  rounds: int = 1, index_base: int = 0) -> torch.Tensor:
    """The plain version of K2: a loop over rounds, each vectorised over
    ``[B, n]``.  Like the kernel it computes a Philox block only where a
    draw can matter (a faulty leader's coins, a relay threshold inside
    (0, 256)); each such check syncs with the host.  Returns ``[B]``
    int8 for ``rounds == 1``, else ``[B, rounds]``; row i draws as
    instance ``index_base + i``."""
    _check_rounds(rounds)
    _check_index_base(index_base)
    B, n = faulty.shape
    dev = faulty.device
    seed_u32 = seed.reshape(-1)[:1].to(dev, torch.int64) & M32
    b = torch.arange(index_base, index_base + B, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    is_leader = j == leader.to(dev, torch.int64)[:, None]
    leader_faulty = faulty.gather(1, leader.long()[:, None])
    honest = alive & ~faulty
    traitor = alive & faulty
    t = traitor.sum(1, keepdim=True)
    order_c = order.to(COMMAND_DTYPE)[:, None]
    ok_r, ok_a = ok[:, 0:1], ok[:, 1:2]
    any_coin = bool((leader_faulty & alive & ~is_leader).any())
    out = torch.empty((B, rounds), dtype=COMMAND_DTYPE, device=dev)
    for rr in range(rounds):
        blocks = {}

        def word(d: int) -> torch.Tensor:
            c = d // 4
            if c not in blocks:
                blocks[c] = philox4x32_10(rr, j, c, 0, seed_u32, b)
            return blocks[c][d % 4]

        received = order_c.expand(B, n)
        if any_coin:
            coin = (word(0) & 1).to(COMMAND_DTYPE)
            received = torch.where(leader_faulty, coin, order_c)
        received = torch.where(is_leader, order_c, received)
        gate = alive & torch.where(received == ATTACK, ok_a, ok_r)
        seen = [(received == RETREAT) & gate, (received == ATTACK) & gate]
        for r in range(1, m + 1):
            thresh = []
            for v in (0, 1):
                held = (seen[v] & honest).any(1, keepdim=True)
                k = (seen[v] & traitor).sum(1, keepdim=True)
                t8 = torch.where(k > 8, 256, 256 - (256 >> k.clamp(max=8)))
                thresh.append(torch.where(held, 256, torch.where(r < t, t8, 0)))
            draws = ((thresh[0] > 0) & (thresh[0] < 256)) | ((thresh[1] > 0) & (thresh[1] < 256))
            w = word(r) if bool(draws.any()) else torch.zeros_like(j)
            for v in (0, 1):
                u = (w >> (8 * v)) & 0xFF
                seen[v] = torch.where(u < thresh[v], alive, seen[v] & alive)
        maj = torch.full_like(received, UNDEFINED)
        maj = torch.where(seen[0] & ~seen[1], RETREAT, maj)
        maj = torch.where(seen[1] & ~seen[0], ATTACK, maj)
        maj = torch.where(is_leader, order_c, maj).to(COMMAND_DTYPE)
        out[:, rr] = quorum_decision(*majority_counts(maj, alive))[0]
    return out[:, 0] if rounds == 1 else out


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_sweep_step
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        lib.ba_philox4x32_10.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.ba_philox4x32_10.restype = ctypes.c_int
    return lib


def kernel_philox4x32_10(words: torch.Tensor) -> torch.Tensor:
    """The generator K2 draws from, run on the card: ``words`` [N, 6]
    integer (counter c0..c3, key k0, k1; uint32 values) on a CUDA device
    -> [N, 4] int64 output words.  For the known-answer check of the
    kernel's own Philox; it is not a launch of K2."""
    if words.device.type != "cuda":
        raise ValueError(f"the Philox kernel runs on a CUDA device, not {words.device}")
    if words.dim() != 2 or words.shape[1] != 6 or words.shape[0] < 1:
        raise ValueError(f"words must be [N >= 1, 6], got {tuple(words.shape)}")
    w = words.to(torch.int64) & M32
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()
    out = torch.empty((w.shape[0], 4), dtype=torch.int32, device=w.device)
    err = _lib().ba_philox4x32_10(w.shape[0], w.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Philox launch failed: CUDA error {err}")
    return out.to(torch.int64) & M32


def fused_signed_sweep_step(seed, order, leader, faulty, alive, ok, m: int = 3,
                            rounds: int = 1, index_base: int = 0) -> torch.Tensor:
    """``rounds`` fused signed-sweep agreement rounds in one launch.

    seed int32 [1] (vary it per dispatch), order int8 [B], leader int32
    [B] (in [0, n)), faulty / alive bool [B, n], ok bool [B, 2] (the
    per-value table verdicts, RETREAT then ATTACK).  Returns decisions
    [B] int8 for ``rounds == 1``, else [B, rounds] int8, column r being
    round r's independent decision.  Row i draws as instance
    ``index_base + i`` (the global index of a shard's first row).
    """
    _check_rounds(rounds)
    _check_index_base(index_base)
    dev = faulty.device
    if dev.type == "cpu":
        return plain_fused_signed_sweep_step(seed, order, leader, faulty, alive, ok, m, rounds,
                                             index_base)
    if dev.type != "cuda":
        raise ValueError(f"the sweep-step kernel runs on a CUDA device, not {dev}")
    B, n = faulty.shape
    if B < 1 or not 1 <= n <= MAX_N or m < 0:
        raise ValueError(f"B={B}, n={n}, m={m} outside the kernel's range "
                         f"(B >= 1, 1 <= n <= {MAX_N}, m >= 0)")
    _build.check_tensor(seed, "seed", torch.int32, (1,), dev)
    _build.check_tensor(order, "order", torch.int8, (B,), dev)
    _build.check_tensor(leader, "leader", torch.int32, (B,), dev)
    _build.check_tensor(faulty, "faulty", torch.bool, (B, n), dev)
    _build.check_tensor(alive, "alive", torch.bool, (B, n), dev)
    _build.check_tensor(ok, "ok", torch.bool, (B, 2), dev)
    dec = torch.empty((B, rounds), dtype=COMMAND_DTYPE, device=dev)
    err = _lib().ba_sweep_step(
        B, n, m, rounds, index_base, seed.data_ptr(), order.data_ptr(), leader.data_ptr(),
        faulty.data_ptr(), alive.data_ptr(), ok.data_ptr(), dec.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sweep-step launch failed: CUDA error {err}")
    fused_signed_sweep_step.launches += 1
    return dec[:, 0] if rounds == 1 else dec


fused_signed_sweep_step.launches = 0


def reset_launches() -> None:
    fused_signed_sweep_step.launches = 0


def fused_sharded_sweep_step(mesh, seed, order, leader, faulty, alive, ok, m: int = 3,
                             rounds: int = 1):
    """The fused step over a device mesh (``ba_tpu/ops/sweep_step.py:299``):
    instances split on the mesh's "data" axis, one
    :func:`fused_signed_sweep_step` a shard on the shard's device (K2 on
    the card, its plain version on the CPU), with no traffic between
    shards.  The inputs are full values (``put_global`` keeps each
    process's shards); ``seed`` is replicated.

    Where the reference seeds shard k with ``seed + k * 0x9E3779B9`` (the
    TPU's hardware generator cannot be keyed by instance), shard k here
    numbers its rows from ``index_base = k * B / d``: the Philox key is
    (seed, global instance index), so any shard count, one included, is
    bit-identical to the unsharded step and no (seed, b) pair is drawn by
    two shards.  Returns the decisions as a Sharded value of the
    reference's global shape (``[B]`` for one round, else ``[B,
    rounds]``); ``np.asarray`` or ``.gather()`` assembles them.
    """
    from ba_tpu_torch.parallel import mesh as _mesh

    B = faulty.shape[0]
    d = mesh.shape["data"]
    if B % d:
        raise ValueError(f"batch {B} does not split over the mesh's {d} \"data\" entries")
    row = _mesh.P("data")
    args = [_mesh.put_global(mesh, x, row) for x in (order, leader, faulty, alive, ok)]

    def local(seed, order, leader, faulty, alive, ok):
        base = _mesh.axis_index("data") * (B // d)
        return fused_signed_sweep_step(seed, order, leader, faulty, alive, ok, m, rounds,
                                       index_base=base)

    step = _mesh.shard_map(local, mesh, row, collectives=False)
    return step(_mesh.gather_tree(seed), *args)
