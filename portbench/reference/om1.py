"""Oral OM(1) with the 3f+1 quorum and the lowest-alive-id election, in
plain PyTorch: the semantics the benchmark holds the program to.

One round of instance b under round key k (int64 ``[2]``):

1. ``k1, k2 = split(k)``; round-1 coins ``coin_bits(k1, (n,))``, the
   answer cube's ``coin_bits(k2, (n, n))`` (n is the capacity).
2. Round 1: a faulty leader sends coin j to general j; an honest one its
   order; the leader itself holds the order.
3. Round 2: responder j tells asker i ``received[j]``, or coin (i, j) when
   j is faulty; everyone answers itself truthfully.  Asker i counts the
   alive responders other than the leader: strict majority, a tie
   UNDEFINED; the leader's majority is its order.
4. Quorum over the alive generals' majorities: ``k = (total - 1) // 3``,
   ``needed = 2k + 1`` (``total - 1`` when total <= 3, 1 when total is
   1); RETREAT is checked before ATTACK; no voters, UNDEFINED.

Round r of a campaign under campaign key K gives instance b the round key
``fold_in(fold_in(K, r), b)``.  A failover round first applies its kills
(``alive &= ~kill``); an instance whose leader died elects the alive
general of lowest id (an all-dead row elects slot 0).

``quorum`` and ``reelect`` exist for the control, which breaks one of
these guarantees on purpose; the benchmark's comparison uses the
defaults.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from portbench.reference import threefry as tf

RETREAT, ATTACK, UNDEFINED = 0, 1, 2
_INT32_MAX = 2**31 - 1
BLOCK_ELEMENTS = 2**27  # answer-cube entries a block: instances x n x n


def needed_3f1(total: torch.Tensor) -> torch.Tensor:
    needed = 2 * torch.div(total - 1, 3, rounding_mode="floor") + 1
    needed = torch.where(total <= 3, total - 1, needed)
    return torch.where(total == 1, torch.ones_like(needed), needed)


def needed_simple_majority(total: torch.Tensor) -> torch.Tensor:
    """The control's quorum: more than half of the voters."""
    return total // 2 + 1


def quorum(majorities: torch.Tensor, alive: torch.Tensor, needed_fn=needed_3f1) -> torch.Tensor:
    n_attack = ((majorities == ATTACK) & alive).sum(-1)
    n_retreat = ((majorities == RETREAT) & alive).sum(-1)
    n_undefined = ((majorities == UNDEFINED) & alive).sum(-1)
    total = n_attack + n_retreat + n_undefined
    needed = needed_fn(total)
    decision = torch.where(needed <= n_attack, ATTACK, UNDEFINED)
    decision = torch.where(needed <= n_retreat, RETREAT, decision)
    return torch.where(total == 0, UNDEFINED, decision).to(torch.int8)


def majorities(keys: torch.Tensor, state: dict) -> torch.Tensor:
    """OM(1)'s majorities ``[B, n]`` int8 of one round, ``keys`` [B, 2]."""
    order, leader = state["order"], state["leader"].long()
    faulty, alive = state["faulty"], state["alive"]
    B, n = faulty.shape
    sub = tf.split(keys)
    coins1 = tf.coin_bits(sub[:, 0], (n,))
    coins2 = tf.coin_bits(sub[:, 1], (n, n))
    idx = torch.arange(n, device=faulty.device)
    is_leader = idx[None, :] == leader[:, None]
    order_c = order[:, None].to(torch.int8)
    leader_faulty = faulty.gather(1, leader[:, None])
    received = torch.where(leader_faulty, coins1, order_c)
    received = torch.where(is_leader, order_c, received)
    answers = torch.where(faulty[:, None, :], coins2, received[:, None, :])
    eye = torch.eye(n, dtype=torch.bool, device=faulty.device)[None]
    answers = torch.where(eye, received[:, None, :], answers)
    weight = alive[:, None, :] & ~is_leader[:, None, :]
    n_attack = ((answers == ATTACK) & weight).sum(-1)
    n_retreat = ((answers == RETREAT) & weight).sum(-1)
    maj = torch.where(n_attack > n_retreat, ATTACK,
                      torch.where(n_retreat > n_attack, RETREAT, UNDEFINED)).to(torch.int8)
    return torch.where(is_leader, order_c, maj)


def _disagree(maj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mmax = torch.where(mask, maj, -127).amax(dim=1)
    mmin = torch.where(mask, maj, 127).amin(dim=1)
    return (mmax != mmin) & mask.any(dim=1)


def round_outputs(keys: torch.Tensor, state: dict, needed_fn=needed_3f1) -> dict:
    """One round over ``state``'s instances in blocks: ``decision`` [B]
    int8 and ``equivocation`` [B] bool (a live traitor is present and the
    alive lieutenants' majorities disagree)."""
    B, n = state["faulty"].shape
    step = max(1, BLOCK_ELEMENTS // (n * n))
    decisions, equivocations = [], []
    for lo in range(0, B, step):
        part = {name: t[lo:lo + step] for name, t in state.items()}
        maj = majorities(keys[lo:lo + step], part)
        idx = torch.arange(n, device=maj.device)
        lieutenants = part["alive"] & (idx[None, :] != part["leader"].long()[:, None])
        traitor = (part["faulty"] & part["alive"]).any(dim=1)
        decisions.append(quorum(maj, part["alive"], needed_fn))
        equivocations.append(_disagree(maj, lieutenants) & traitor)
    return {"decision": torch.cat(decisions), "equivocation": torch.cat(equivocations)}


def round_keys(campaign_key: torch.Tensor, rnd: int, instances: torch.Tensor) -> torch.Tensor:
    """``fold_in(fold_in(K, rnd), b)`` for each global instance index b."""
    kr = tf.fold_in(campaign_key, rnd)
    return tf.fold_in(kr[None, :], instances.to(torch.int64))


def plain_round(campaign_key: torch.Tensor, rnd: int, state: dict, needed_fn=needed_3f1) -> dict:
    """Round ``rnd`` of a plain campaign over the whole batch: each
    instance's decision, the 3-bin histogram and the round's counter
    increments (quorum failures, unanimity, equivocations)."""
    B = state["faulty"].shape[0]
    keys = round_keys(campaign_key, rnd, torch.arange(B, device=state["faulty"].device))
    out = round_outputs(keys, state, needed_fn)
    hist = torch.bincount(out["decision"].long(), minlength=3)
    deltas = torch.stack([(out["decision"] == UNDEFINED).sum(), (hist.max() == B).long(),
                          out["equivocation"].sum()])
    return {"decision": out["decision"], "histogram": hist, "deltas": deltas}


def campaign_decisions(campaign_key: torch.Tensor, rounds: int, state: dict,
                       instances: torch.Tensor, needed_fn=needed_3f1) -> torch.Tensor:
    """Decisions ``[rounds, k]`` of a plain campaign's instances in every
    round: ``state`` holds their rows, ``instances`` their global indices."""
    keys = torch.cat([round_keys(campaign_key, r, instances) for r in range(rounds)])
    rep = {name: t.repeat((rounds,) + (1,) * (t.dim() - 1)) for name, t in state.items()}
    return round_outputs(keys, rep, needed_fn)["decision"].reshape(rounds, len(instances))


def elect_lowest_id(ids: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    masked = torch.where(alive, ids, torch.full_like(ids, _INT32_MAX))
    return torch.argmin(masked, dim=-1).to(torch.int32)


def failover_campaign(campaign_key: torch.Tensor, state: dict, instances: torch.Tensor,
                      kills: torch.Tensor, *, reelect: bool = True) -> dict:
    """A failover campaign over some instances: ``state`` holds their
    rows, ``instances`` their global indices, ``kills`` their rows of the
    kill plane ``[R, b, n]``.  Returns ``leaders`` and ``decisions`` [R, b]
    (leaders after each round's election)."""
    st = dict(state)
    leaders, decisions = [], []
    for r in range(kills.shape[0]):
        alive = st["alive"] & ~kills[r]
        leader = st["leader"]
        if reelect:
            leader_alive = alive.gather(1, leader.long()[:, None])[:, 0]
            leader = torch.where(leader_alive, leader, elect_lowest_id(st["ids"], alive))
        st = dict(st, alive=alive, leader=leader)
        out = round_outputs(round_keys(campaign_key, r, instances), st)
        leaders.append(leader)
        decisions.append(out["decision"])
    return {"leaders": torch.stack(leaders), "decisions": torch.stack(decisions)}
