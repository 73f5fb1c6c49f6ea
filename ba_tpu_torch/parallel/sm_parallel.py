"""SM(m) with one signed cluster's generals split over the mesh's "node"
axis (``ba_tpu/parallel/sm_parallel.py``): BASELINE config #4's point
(n = 1024, m = 32) across entries.

Each node shard keeps only its generals' V-sets ``seen[b, n_local, 2]``:

- collapsed relay round: the only cross-shard state is the ``[b, 2]``
  honest-holder and traitor-holder counts, summed over "node" a round;
- exact relay round: each shard gathers the global V-sets ``[b, n, 2]``
  over "node" and draws coins for its own receivers only;
- quorum: one :func:`psum` over "node", as ``om1_node_sharded``.

Round 1 runs on the whole batch (``multihost.round1``) unless
``received`` pins it; the relay coins draw from ``fold_in(key, 1000 +
node_idx + d_node * data_idx)``, as the reference's, so a mesh of the
same shape gives the reference's bits.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.sm import choice_from_seen
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, RETREAT
from ba_tpu_torch.parallel.mesh import (
    P, all_gather, axis_index, gather_tree, psum, put_global, shard_map,
)
from ba_tpu_torch.parallel.multihost import round1
from ba_tpu_torch.parallel.node_parallel import (
    OUT_SPECS, as_dict, node_split, quorum_over_node, shard_inputs,
)


def sm_node_sharded(mesh, key: torch.Tensor, state: SimState, m: int, *, received=None,
                    sig_valid=None, withhold=None, collapsed: bool = True) -> dict:
    """SM(m) agreement with generals sharded over the "node" mesh axis.

    ``state`` has batch B (split over "data") and n divisible by the node
    axis.  ``received`` / ``sig_valid`` ([B, n], tensors or Sharded) pin
    the round-1 values and their signature validity, as in ``sm_round``.
    ``collapsed`` picks the O(n)-a-round fair-coin relay; the exact relay
    (``collapsed=False``) may follow a pinned adversary schedule
    ``withhold`` ([m, B, n, n, 2] bool, receivers split over "node").
    Returns the ``om1_agreement``-style dict of Sharded values.
    """
    if withhold is not None and collapsed:
        raise ValueError("collapsed relay cannot honor a withhold schedule")
    state = gather_tree(state)
    n = state.n
    n_local = node_split(mesh, n)
    n_node = mesh.shape["node"]
    if received is None:
        k1, key = rng.split(key).unbind(-2)
        received = round1(k1, state)
    has_sig = sig_valid is not None
    extra = [sig_valid] if has_sig else []
    args = [key, *shard_inputs(mesh, state, received, *extra)]
    if withhold is not None:
        args.append(put_global(mesh, withhold, P(None, "data", "node", None, None)))

    def shard_fn(key, order, leader, faulty, alive, rcv, *more):
        dev = faulty.device
        node_idx, data_idx = axis_index("node"), axis_index("data")
        b = order.shape[0]
        i_global = node_idx * n_local + torch.arange(n_local, device=dev)
        honest = alive & ~faulty
        traitor = faulty & alive
        t = traitor.sum(-1, dtype=torch.int32)  # [b] coalition size
        alive_l = alive[:, i_global]
        honest_l, traitor_l, rcv_l = honest[:, i_global], traitor[:, i_global], rcv[:, i_global]

        # This shard's generals' V-sets after the signed round-1 push.
        seen_l = torch.stack([rcv_l == RETREAT, rcv_l == ATTACK], dim=-1) & alive_l[..., None]
        more = list(more)
        if has_sig:
            seen_l = seen_l & more.pop(0)[:, i_global, None]
        wh_l = more.pop(0) if more else None  # [m, b, n_local, n, 2]
        k_relay = rng.fold_in(key, 1000 + node_idx + n_node * data_idx)

        for r in range(1, m + 1):
            if collapsed:
                held = (seen_l & honest_l[..., None]).sum(1, dtype=torch.int32)  # [b, 2]
                k_cnt = (seen_l & traitor_l[..., None]).sum(1, dtype=torch.int32)
                held, k_cnt = psum((held, k_cnt), "node")
                held_honest = held > 0
                chain_ok = (r < t)[:, None] | held_honest
                thresh = rng.or_coin_threshold8(k_cnt, chain_ok)
                u = rng.uniform_u8(rng.fold_in(k_relay, r), (b, n_local, 2))
                incoming = (u < thresh[:, None, :]) | held_honest[:, None, :]
            else:
                seen_g = all_gather(seen_l, "node", axis=1)  # [b, n, 2]
                held_honest = (seen_g & honest[..., None]).any(1)
                chain_ok = (r < t)[:, None] | held_honest
                if wh_l is not None:
                    coins = ~wh_l[r - 1]
                else:
                    coins = rng.coin_bits(rng.fold_in(k_relay, r), (b, n_local, n, 2),
                                          torch.bool)
                faulty_sends = (seen_g[:, None] & coins & faulty[:, None, :, None]
                                & chain_ok[:, None, None, :])
                honest_sends = seen_g[:, None] & honest[:, None, :, None]
                sends = (faulty_sends | honest_sends) & alive[:, None, :, None]
                incoming = sends.any(2)  # [b, n_local, 2]
            seen_l = (seen_l | incoming) & alive_l[..., None]

        maj = choice_from_seen(seen_l)
        maj = torch.where(i_global[None, :] == leader[:, None], order[:, None], maj)
        return quorum_over_node(maj, alive_l)

    return as_dict(shard_map(shard_fn, mesh, OUT_SPECS)(*args))


__all__ = ["sm_node_sharded"]
