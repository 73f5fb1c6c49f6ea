"""OM(1) with one cluster's generals split over the mesh's "node" axis
(``ba_tpu/parallel/node_parallel.py``).

The round-2 answer cube is ``O(B n^2)``; its receiver axis splits over
"node", so each entry holds ``O(B n n / d_node)``:

- the round-1 ``received`` row is recomputed on every node shard from
  ``fold_in(key, data_idx)``, so no broadcast is needed;
- round 2's answers for this shard's receivers draw from
  ``fold_in(fold_in(key, node_idx + 1000), data_idx)``;
- the quorum counts are summed over "node" (one :func:`psum`).

The coins are keyed by shard, as the reference's are, so the result is
bit-exact with the reference on a mesh of the same shape.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.quorum import quorum_decision, strict_majority
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, RETREAT, UNDEFINED
from ba_tpu_torch.parallel.mesh import P, axis_index, gather_tree, psum, put_global, shard_map

ROW = P("data")
OUT_SPECS = (P("data", "node"),) + (ROW,) * 6
OUT_NAMES = ("majorities", "decision", "needed", "total", "n_attack", "n_retreat",
             "n_undefined")


def node_split(mesh, n: int) -> int:
    """Receivers a node shard owns; raises unless the node axis divides n."""
    n_node = mesh.shape["node"]
    if n % n_node:
        raise ValueError(f"node axis {n_node} must divide n={n}")
    return n // n_node


def quorum_over_node(maj: torch.Tensor, alive_local: torch.Tensor) -> tuple:
    """The shard's receivers' counts summed over "node", then the quorum:
    the ``om1_agreement``-style outputs after the majorities."""
    counts = tuple(((maj == code) & alive_local).sum(-1, dtype=torch.int32)
                   for code in (ATTACK, RETREAT, UNDEFINED))
    att, ret, und = psum(counts, "node")
    decision, needed, total = quorum_decision(att, ret, und)
    return maj, decision, needed, total, att, ret, und


def shard_inputs(mesh, state: SimState, *planes) -> list:
    """The state's order, leader, faulty, alive and any extra ``[B, n]``
    planes split on "data" (the node axis replicated)."""
    return [put_global(mesh, x, ROW)
            for x in (state.order, state.leader, state.faulty, state.alive, *planes)]


def as_dict(out: tuple) -> dict:
    return dict(zip(OUT_NAMES, out))


def om1_node_sharded(mesh, key: torch.Tensor, state: SimState) -> dict:
    """OM(1) agreement with generals sharded over the "node" mesh axis.

    ``state`` has batch B (split over "data") and n divisible by the node
    axis.  Returns the ``om1_agreement``-style dict of Sharded values:
    ``majorities`` [B, n], and the [B] quorum outputs.
    """
    state = gather_tree(state)
    n = state.n
    n_local = node_split(mesh, n)

    def shard_fn(key, order, leader, faulty, alive):
        dev = faulty.device
        node_idx, data_idx = axis_index("node"), axis_index("data")
        b = order.shape[0]
        j = torch.arange(n, device=dev)
        i_global = node_idx * n_local + torch.arange(n_local, device=dev)
        order_c = order[:, None]

        # Round 1, recomputed on every node shard from the data shard's key.
        coins1 = rng.coin_bits(rng.fold_in(key, data_idx), (b, n))
        leader_faulty = faulty.gather(1, leader.long()[:, None])
        received = torch.where(leader_faulty, coins1, order_c)
        is_leader_j = j[None, :] == leader[:, None]
        received = torch.where(is_leader_j, order_c, received)

        # Round 2 for this shard's receivers only.
        k_r2 = rng.fold_in(rng.fold_in(key, node_idx + 1000), data_idx)
        coins2 = rng.coin_bits(k_r2, (b, n_local, n))
        answers = torch.where(faulty[:, None, :], coins2, received[:, None, :])
        own = i_global[None, :, None] == j[None, None, :]
        answers = torch.where(own, received[:, None, :], answers)

        weight = alive[:, None, :] & ~is_leader_j[:, None, :]
        n_att = ((answers == ATTACK) & weight).sum(-1, dtype=torch.int32)
        n_ret = ((answers == RETREAT) & weight).sum(-1, dtype=torch.int32)
        maj = strict_majority(n_att, n_ret)
        maj = torch.where(i_global[None, :] == leader[:, None], order_c, maj)
        return quorum_over_node(maj, alive[:, i_global])

    out = shard_map(shard_fn, mesh, OUT_SPECS)(key, *shard_inputs(mesh, state))
    return as_dict(out)


__all__ = ["om1_node_sharded"]
