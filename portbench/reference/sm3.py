"""Signed, collapsed SM(m) rounds as the fused sweep step defines them, in
plain PyTorch: the semantics the benchmark holds K2 to.

Randomness is Philox4x32-10 (Random123).  Draw d of general j in round rr
of instance b (its row in its bucket) is word d % 4 of
``philox(counter=(rr, j, d // 4, 0), key=(seed as uint32, b))``: d = 0 the
round-1 coin (bit 0), d = r relay round r (byte 0 gates RETREAT, byte 1
ATTACK).

One round: a faulty leader sends coin j to general j, an honest one its
order, the leader holds its order.  A value counts where the general is
alive and the commander's signature on it verified (``ok`` [B, 2], RETREAT
then ATTACK).  Relay round r = 1..m: for each value, ``held`` when an
honest general has it, ``k`` the traitors that have it; its threshold is
256 when held, else ``256 - (256 >> min(k, 8))`` (256 past 8) while r < t
(t the instance's live traitors), else 0; every alive general has the
value after the round where its draw's byte is below the threshold.  The
majority is RETREAT or ATTACK where a general holds only that value,
UNDEFINED otherwise, the leader's its order; then the 3f+1 quorum over the
alive generals (``om1.quorum``).

Nothing here imports the program.
"""

from __future__ import annotations

import torch

from portbench.reference.om1 import ATTACK, RETREAT, UNDEFINED, quorum

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS_A_BLOCK = 96


def _mulhilo(a: torch.Tensor, mult: int):
    p_lo = (a & 0xFFFF) * mult
    s = (a >> 16) * mult + (p_lo >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values -> four words."""
    c0, c1, c2, c3, k0, k1 = torch.broadcast_tensors(c0, c1, c2, c3, k0, k1)
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & M32
            k1 = (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def decisions(seed: int, state: dict, ok: torch.Tensor, rows: torch.Tensor, m: int,
              rounds: int) -> torch.Tensor:
    """Decisions ``[len(rows), rounds]`` int8 of the instances ``rows``
    (row numbers of ``state``, whose rows hold their inputs) under the
    step's ``seed`` (an int32 value)."""
    if not 1 <= m <= 3:
        raise ValueError(f"m={m}: draws 1..m share the round-1 coin's Philox block for m <= 3")
    dev = state["faulty"].device
    st = {name: t[rows] for name, t in state.items()}
    ok = ok[rows]
    R, n = st["faulty"].shape
    b = rows.to(torch.int64).reshape(R, 1, 1)
    j = torch.arange(n, dtype=torch.int64, device=dev).reshape(1, 1, n)
    leader = st["leader"].long()
    is_leader = (j == leader.reshape(R, 1, 1))
    alive = st["alive"][:, None, :]
    faulty = st["faulty"][:, None, :]
    honest, traitor = alive & ~faulty, alive & faulty
    t = traitor.sum(-1, keepdim=True)
    order_c = st["order"].to(torch.int8).reshape(R, 1, 1)
    leader_faulty = st["faulty"].gather(1, leader[:, None]).reshape(R, 1, 1)
    ok_r, ok_a = ok[:, 0].reshape(R, 1, 1), ok[:, 1].reshape(R, 1, 1)
    seed_u32 = torch.tensor(int(seed) & M32, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for lo in range(0, rounds, ROUNDS_A_BLOCK):
        rr = torch.arange(lo, min(rounds, lo + ROUNDS_A_BLOCK), dtype=torch.int64,
                          device=dev).reshape(1, -1, 1)
        words = philox4x32_10(rr, j, zero, zero, seed_u32, b)
        coin = (words[0] & 1).to(torch.int8)
        received = torch.where(leader_faulty, coin, order_c)
        received = torch.where(is_leader, order_c, received)
        gate = alive & torch.where(received == ATTACK, ok_a, ok_r)
        seen = [(received == RETREAT) & gate, (received == ATTACK) & gate]
        for r in range(1, m + 1):
            thresh = []
            for v in (0, 1):
                held = (seen[v] & honest).any(-1, keepdim=True)
                k = (seen[v] & traitor).sum(-1, keepdim=True)
                t8 = torch.where(k > 8, 256, 256 - (256 >> k.clamp(max=8)))
                thresh.append(torch.where(held, 256, torch.where(r < t, t8, 0)))
            for v in (0, 1):
                u = (words[r] >> (8 * v)) & 0xFF
                seen[v] = torch.where(u < thresh[v], alive, seen[v] & alive)
        maj = torch.full(received.shape, UNDEFINED, dtype=torch.int8, device=dev)
        maj = torch.where(seen[0] & ~seen[1], RETREAT, maj)
        maj = torch.where(seen[1] & ~seen[0], ATTACK, maj)
        maj = torch.where(is_leader, order_c, maj).to(torch.int8)
        nr = maj.shape[1]
        dec = quorum(maj.reshape(R * nr, n), alive.expand(R, nr, n).reshape(R * nr, n))
        out.append(dec.reshape(R, nr))
    return torch.cat(out, dim=1)
