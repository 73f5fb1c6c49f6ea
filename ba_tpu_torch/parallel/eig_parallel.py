"""OM(m) by the EIG tree with its receiver axis split over the mesh's
"node" axis (``ba_tpu/parallel/eig_parallel.py``).

Level m, ``[B, n, n^m]``, is the tree's largest object; each node shard
holds its receivers' copies, ``O(B n^(m+1) / d_node + B n^m)``:

- send: each relay level needs every general's copies of the level
  before, so each level but the last gathers it over "node"
  (:func:`all_gather`), a factor n smaller than the level it builds;
- resolve: the bottom-up masked majorities are per receiver, so local;
- quorum: one :func:`psum` over "node".

Round 1 runs on the whole batch under the first half of the key
(``multihost.round1``); the relay coins draw from ``fold_in(key, node_idx
+ d_node * data_idx)``, as the reference's, so a mesh of the same shape
gives the reference's bits.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.eig import _in_path_mask
from ba_tpu_torch.core.quorum import strict_majority
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, RETREAT
from ba_tpu_torch.parallel.mesh import all_gather, axis_index, gather_tree, shard_map
from ba_tpu_torch.parallel.multihost import round1
from ba_tpu_torch.parallel.node_parallel import (
    OUT_SPECS, as_dict, node_split, quorum_over_node, shard_inputs,
)


def eig_node_sharded(mesh, key: torch.Tensor, state: SimState, m: int) -> dict:
    """OM(m), m >= 1, with the EIG tree's receiver axis sharded over
    "node"; ``state`` has batch B (split over "data") and n divisible by
    the node axis.  Returns the ``om1_agreement``-style dict of Sharded
    values (``majorities`` [B, n], the [B] quorum outputs)."""
    state = gather_tree(state)
    n = state.n
    n_local = node_split(mesh, n)
    n_node = mesh.shape["node"]
    k1, key = rng.split(key).unbind(-2)
    received = round1(k1, state)

    def shard_fn(key, order, leader, faulty, alive, rcv):
        dev = faulty.device
        node_idx, data_idx = axis_index("node"), axis_index("data")
        b = order.shape[0]
        j = torch.arange(n, device=dev)
        i_global = node_idx * n_local + torch.arange(n_local, device=dev)
        k_shard = rng.fold_in(key, node_idx + n_node * data_idx)

        # Send: levels_local[l] is [b, n_local, n^l], this shard's receivers'
        # copies; prev_global the whole previous level.
        levels_local = [rcv[:, i_global, None]]
        prev_global = rcv[..., None]
        self_honest = i_global[None, :, None] == j[None, None, :]
        lying = faulty[:, None, None, :] & ~self_honest[:, :, None, :]
        for level in range(m):
            p_sz = n**level
            coins = rng.coin_bits(rng.fold_in(k_shard, level), (b, n_local, p_sz, n))
            relayed = prev_global.permute(0, 2, 1)[:, None, :, :]
            nxt = torch.where(lying, coins, relayed).reshape(b, n_local, p_sz * n)
            levels_local.append(nxt)
            if level < m - 1:
                prev_global = all_gather(nxt, "node", axis=1)

        # Resolve, locally: core/eig.eig_resolve on this shard's slice.
        is_leader = j[None, :] == leader[:, None]
        resolved = levels_local[m]
        for level in range(m - 1, -1, -1):
            p_sz = n**level
            children = resolved.reshape(b, n_local, p_sz, n)
            in_path = _in_path_mask(n, level, dev)
            valid = (alive[:, None, None, :] & ~is_leader[:, None, None, :]
                     & ~in_path[None, None, :, :])
            n_attack = ((children == ATTACK) & valid).sum(-1, dtype=torch.int32)
            n_retreat = ((children == RETREAT) & valid).sum(-1, dtype=torch.int32)
            resolved = torch.where(valid.any(-1), strict_majority(n_attack, n_retreat),
                                   levels_local[level].reshape(b, n_local, p_sz))
        maj = resolved.reshape(b, n_local)
        maj = torch.where(i_global[None, :] == leader[:, None], order[:, None], maj)
        return quorum_over_node(maj, alive[:, i_global])

    out = shard_map(shard_fn, mesh, OUT_SPECS)(key, *shard_inputs(mesh, state, received))
    return as_dict(out)


__all__ = ["eig_node_sharded"]
