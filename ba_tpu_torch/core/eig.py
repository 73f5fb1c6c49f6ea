"""OM(m) as a dense EIG (Exponential Information Gathering) tree
(``ba_tpu/core/eig.py``).

Level ``l`` of every general's tree is ``V_l[b, i, p]``, ``[B, n,
n**l]`` int8: what general i holds for relay path p.  The send phase is
l all-to-all relay rounds; the resolve phase folds the tree bottom-up
with one masked strict majority a level, K9 on the card
(``ops/majority.py``): at path p the children p.j are counted over
relays j alive, not the leader and not in p; a tie gives UNDEFINED; no
eligible relay gives the stored copy (the OM(0) base case).

- Faulty relays lie with a fair coin per (receiver, path) message, or
  their strategy's value; a general keeps its own copies honest.
- ``eig_deepest_fused`` resolves the deepest level without building
  it: honest tallies are a 0/1 matrix product over level m - 1, the
  liars' coins a Binomial(k, 1/2) draw (``_binomial_half``).  It is the
  default at m >= 2 (``fused=True``; the reference's
  ``BA_TPU_EIG_FUSED=0`` is ``fused=False``); a strategies plane forces
  the dense path, whose coin collapse holds for fair coins only.

Two key modes, both bit-exact with the reference:

- one key data ``[2]`` for the whole batch (``eig_agreement`` as the
  benches call it): every draw is one stream over the batch, e.g.
  ``coin_bits(key, (B, n, P, n))``;
- one key a row, ``[B, 2]`` (``agreement_step``): row b draws what a
  B = 1 round under its own key draws, ``coin_bits(key_b, (n, P, n))``.
"""

from __future__ import annotations

import functools

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.om import _leader_mask, round1_apply
from ba_tpu_torch.core.quorum import majority_counts, quorum_decision, strict_majority
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK
from ba_tpu_torch.ops import majority
from ba_tpu_torch.scenario.strategies import lie_values


def _coin(key: torch.Tensor, batch: int, shape) -> torch.Tensor:
    """Fair coins ``[batch, *shape]``: one stream over the batch (key
    ``[2]``) or one a row (keys ``[batch, 2]``)."""
    if key.dim() == 1:
        return rng.coin_bits(key, (batch, *shape))
    return rng.coin_bits(key, tuple(shape))


def _check_key(key: torch.Tensor, state: SimState) -> None:
    if key.dim() not in (1, 2) or (key.dim() == 2 and key.shape[0] != state.batch):
        raise ValueError(f"key must be [2] or [{state.batch}, 2], got {tuple(key.shape)}")


@functools.lru_cache(maxsize=64)
def _in_path_mask(n: int, level: int, device=torch.device("cpu")) -> torch.Tensor:
    """``[n**level, n]`` bool: is relay j one of path p's digits?  Built on
    ``device`` (no upload) and kept."""
    P = n**level
    p = torch.arange(P, device=device)
    j = torch.arange(n, device=device)
    mask = torch.zeros((P, n), dtype=torch.bool, device=device)
    for k in range(level):
        mask |= ((p // n**k) % n)[:, None] == j[None, :]
    return mask


def eig_send(key: torch.Tensor, state: SimState, m: int, strategies=None) -> list:
    """Levels V_0..V_m.  V_0 is the round-1 broadcast (a coin per
    recipient of a faulty leader); V_{l+1}[b, i, p*n + j] is what j told
    i about path p: its copy V_l[b, j, p], or, j faulty and not i, a
    fresh coin (its strategy's value per receiver, where given)."""
    _check_key(key, state)
    B, n = state.faulty.shape
    dev = state.device
    keys = rng.split(key, m + 1)
    levels = [round1_apply(state, _coin(keys[..., 0, :], B, (n,)), strategies)]
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    receiver = torch.arange(n, device=dev)[None, :, None, None]
    lying = state.faulty[:, None, None, :] & ~eye[None, :, None, :]  # [B, i, 1, j]
    for level in range(m):
        P = n**level
        prev = levels[-1].reshape(B, n, P)
        coins = _coin(keys[..., level + 1, :], B, (n, P, n))
        if strategies is not None:
            coins = lie_values(strategies[:, None, None, :], coins, receiver)
        relayed = prev.transpose(1, 2)[:, None, :, :]  # [b, 1, p, j] = V_l[b, j, p]
        levels.append(torch.where(lying, coins, relayed).reshape(B, n, P * n))
    return levels


def eig_resolve(state: SimState, levels: list) -> torch.Tensor:
    """Fold the whole tree from its raw deepest level: majorities [B, n] int8."""
    B, n = state.faulty.shape
    m = len(levels) - 1
    return _resolve_from(state, levels, levels[m].reshape(B, n, n**m), m)


def _resolve_from(state: SimState, levels: list, resolved: torch.Tensor,
                  start_level: int) -> torch.Tensor:
    """Fold ``resolved`` (values at ``start_level``) down to per-general
    majorities [B, n] int8, one ``majority.masked_majority_rows`` a level
    (K9 on the card), its mask shared by the n receivers."""
    B, n = state.faulty.shape
    is_leader = _leader_mask(state)
    for level in range(start_level - 1, -1, -1):
        P = n**level
        children = resolved.reshape(B, n, P, n)
        in_path = _in_path_mask(n, level, state.device)
        valid = (state.alive[:, None, None, :] & ~is_leader[:, None, None, :]
                 & ~in_path[None, None])  # [B, 1, P, n]
        resolved = majority.masked_majority_rows(
            children, valid, levels[level].reshape(B, n, P))
    majorities = resolved.reshape(B, n)
    return torch.where(is_leader, state.order[:, None], majorities)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values below 2**32 (SWAR; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _binomial_half(key: torch.Tensor, k: torch.Tensor, max_k: int) -> torch.Tensor:
    """Exact Binomial(k, 1/2) draws, int32 at ``k``'s shape: the set bits
    among the first k of max_k random bits a lane (``bits(key, (*shape,
    W))``, W = ceil(max_k / 32) words).  With keys ``[B, 2]`` row b draws
    ``bits(key_b, (*shape[1:], W))``."""
    W = -(-max_k // 32) if max_k > 0 else 1
    shape = (*k.shape, W) if key.dim() == 1 else (*k.shape[1:], W)
    words = rng.bits(key, shape)
    base = torch.arange(W, dtype=torch.int64, device=k.device) * 32
    nbits = (k[..., None].to(torch.int64) - base).clamp(0, 32)
    mask = (1 << nbits) - 1  # int64: all 32 ones at nbits = 32
    return _popcount32(words & mask).sum(-1, dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _path_digit_first(n: int, level: int, device=torch.device("cpu")):
    """digits int64 ``[level, P]`` (digit d of path p) and first bool
    ``[level, P]`` (position d is the first occurrence of its value in p:
    the in-path exclusion is a set, so a repeated digit is corrected
    once).  Built on ``device`` and kept."""
    P = n**level
    p = torch.arange(P, device=device)
    digits = torch.stack([(p // n**d) % n for d in range(level)]) if level else \
        torch.zeros((0, P), dtype=torch.int64, device=device)
    first = torch.ones((level, P), dtype=torch.bool, device=device)
    for d in range(level):
        for e in range(d):
            first[d] &= digits[d] != digits[e]
    return digits, first


def eig_deepest_fused(key: torch.Tensor, state: SimState, levels: list, m: int,
                      max_liars: int | None = None) -> torch.Tensor:
    """The deepest resolve level without building level m: resolved
    ``[B, n, n**(m-1)]`` int8.

    Honest eligible relays add their copies (a 0/1 matrix product over
    level m - 1), lying ones a Binomial(k, 1/2) draw; the in-path and
    self exclusions are per-digit corrections.  ``max_liars`` (default
    n - 1) sizes the draw and CLAMPS the lying count, so callers derive
    it from the state, never guess it.
    """
    B, n = state.faulty.shape
    dev = state.device
    level = m - 1
    P = n**level
    if max_liars is None:
        max_liars = n - 1
    prev = levels[level].reshape(B, n, P)
    att = prev == ATTACK  # relay j's copies, [B, j, P]
    eligible = state.alive & ~_leader_mask(state)  # [B, j]
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    m1 = eligible[:, None, :] & (~state.faulty[:, None, :] | eye[None])  # [B, i, j]
    lying = eligible[:, None, :] & state.faulty[:, None, :] & ~eye[None]
    # The reference's int8 einsum "bij,bjp->bip" as a float32 product: torch
    # has no int8 bmm on CUDA.  It is exact: the entries are 0 / 1 (exact in
    # TF32 too) and every sum is at most n - 1 < 2**24.  A bf16 or fp16
    # OUTPUT would not be: counts above 256 (bf16) or 2048 (fp16) round.
    n_att = torch.bmm(m1.to(torch.float32), att.to(torch.float32)).to(torch.int32)
    k = lying.sum(-1, dtype=torch.int32)[:, :, None].expand(B, n, P)
    n_elig = eligible.sum(-1, dtype=torch.int32)[:, None, None].expand(B, n, P)
    digits, firsts = _path_digit_first(n, level, dev)
    ar_p = torch.arange(P, device=dev)
    att_i, m1_i = att.to(torch.int32), m1.to(torch.int32)
    lying_i, elig_i = lying.to(torch.int32), eligible.to(torch.int32)
    for d in range(level):
        dg, fo = digits[d], firsts[d][None, None, :]
        att_d = att_i[:, dg, ar_p]  # relay dg[p]'s own copy of path p, [B, P]
        n_att = n_att - torch.where(fo, m1_i[:, :, dg] * att_d[:, None, :], 0)
        k = k - torch.where(fo, lying_i[:, :, dg], 0)
        n_elig = n_elig - torch.where(fo, elig_i[:, dg][:, None, :], 0)
    k = k.clamp(max=max_liars)
    n_att = n_att + _binomial_half(key, k, max_liars)
    resolved = strict_majority(n_att, n_elig - n_att)
    return torch.where(n_elig > 0, resolved, prev)


def eig_round(key: torch.Tensor, state: SimState, m: int, max_liars: int | None = None,
              strategies=None, *, fused: bool = True) -> torch.Tensor:
    """Full OM(m) exchange -> majorities [B, n] int8.  m = 0 trusts the
    leader; m = 1 is the dense tree; m >= 2 resolves its deepest level
    fused unless ``fused=False`` or a strategies plane is given."""
    _check_key(key, state)
    if m < 0:
        raise ValueError(f"m={m} must be >= 0")
    if m == 0:
        return round1_apply(state, _coin(key, state.batch, (state.n,)), strategies)
    if not (fused and m >= 2 and strategies is None):
        return eig_resolve(state, eig_send(key, state, m, strategies))
    k_send, k_coin = rng.split(key).unbind(-2)
    levels = eig_send(k_send, state, m - 1)  # levels 0..m-1 only
    resolved = eig_deepest_fused(k_coin, state, levels, m, max_liars)
    return _resolve_from(state, levels, resolved, m - 1)


def eig_agreement(key: torch.Tensor, state: SimState, m: int, max_liars: int | None = None,
                  *, fused: bool = True) -> dict:
    """OM(m) agreement and the global quorum: ``om1_agreement``'s dict."""
    majorities = eig_round(key, state, m, max_liars, fused=fused)
    n_attack, n_retreat, n_undefined = majority_counts(majorities, state.alive)
    decision, needed, total = quorum_decision(n_attack, n_retreat, n_undefined)
    return {
        "majorities": majorities,
        "decision": decision,
        "needed": needed,
        "total": total,
        "n_attack": n_attack,
        "n_retreat": n_retreat,
        "n_undefined": n_undefined,
    }
