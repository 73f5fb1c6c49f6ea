"""SM(m): signed-message agreement on the collapsed relay
(``ba_tpu/core/sm.py``).

- ``seen[b, i, v]`` (v in {RETREAT, ATTACK}) is general i's V-set; values
  enter it only through the commander's signed round-1 row.
- A relay round on the collapsed path draws, per receiver and value, one
  8-bit uniform against the threshold of the OR of k fair coins (k =
  alive traitors holding v), gated by the chain bound ``r < t`` (t =
  alive traitors, a faulty commander included); a value held by any
  honest general reaches every alive general.
- ``choice(V)``: exactly one value -> that value, else UNDEFINED; the
  commander reports its own order.

Only the collapsed relay (``collapsed=True``) is ported: the exact
per-(receiver, sender) cube, ``withhold`` schedules and strategies wait
for the signed engine (ROADMAP Queue 1, Slice B).  On the same keys every
draw and output is bit-exact with the JAX package.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.om import round1_broadcast
from ba_tpu_torch.core.quorum import majority_counts, quorum_decision
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED

_QUEUED = ("is not ported yet (ROADMAP Queue 1, Slice B: the exact relay "
           "cube and the signed engine); use collapsed=True")


def _initial_seen(state: SimState, received: torch.Tensor) -> torch.Tensor:
    """seen[b, i, v] after the commander's signed round-1 push."""
    vals = torch.stack([received == RETREAT, received == ATTACK], dim=-1)
    return vals & state.alive[..., None]


def sm_relay_rounds_collapsed(key: torch.Tensor, state: SimState, seen: torch.Tensor,
                              m: int) -> torch.Tensor:
    """m collapsed relay rounds; round r draws ``uniform_u8(fold_in(key, r),
    (B, n, 2))``.  Returns the final seen masks."""
    B, n = state.faulty.shape
    traitor = state.faulty & state.alive
    honest = state.alive & ~state.faulty
    t = traitor.sum(-1)
    for r in range(1, m + 1):
        held_honest = (seen & honest[..., None]).any(dim=1)  # [B, 2]
        chain_ok = (r < t)[:, None] | held_honest
        k_cnt = (seen & traitor[..., None]).sum(dim=1)
        thresh = rng.or_coin_threshold8(k_cnt, chain_ok)
        u = rng.uniform_u8(rng.fold_in(key, r), (B, n, 2))
        incoming = (u < thresh[:, None, :]) | held_honest[:, None, :]
        seen = (seen | incoming) & state.alive[..., None]
    return seen


def choice_from_seen(seen: torch.Tensor) -> torch.Tensor:
    """[..., 2] V-sets -> [...] int8: one value -> it, else UNDEFINED."""
    has_r, has_a = seen[..., 0], seen[..., 1]
    out = torch.full(has_r.shape, UNDEFINED, dtype=COMMAND_DTYPE, device=seen.device)
    out = torch.where(has_r & ~has_a, RETREAT, out)
    return torch.where(has_a & ~has_r, ATTACK, out)


def sm_choice(state: SimState, seen: torch.Tensor) -> torch.Tensor:
    """choice(V) per general, the commander reporting its own order."""
    idx = torch.arange(state.n, device=state.device)
    is_leader = idx[None, :] == state.leader[:, None]
    return torch.where(is_leader, state.order[:, None], choice_from_seen(seen))


def sm_round(key: torch.Tensor, state: SimState, m: int, withhold=None, sig_valid=None,
             received=None, collapsed: bool = False, strategies=None) -> torch.Tensor:
    """Full SM(m) exchange -> choices [B, n] int8.  ``split(key)`` gives
    the round-1 key (used unless ``received`` pins the broadcast) and the
    relay key; ``sig_valid`` drops unauthenticated round-1 values."""
    if withhold is not None or strategies is not None or not collapsed:
        raise NotImplementedError(f"sm_round without the collapsed relay {_QUEUED}")
    k1, k2 = rng.split(key).unbind(-2)
    if received is None:
        received = round1_broadcast(k1, state)
    seen = _initial_seen(state, received)
    if sig_valid is not None:
        seen = seen & sig_valid[..., None]
    return sm_choice(state, sm_relay_rounds_collapsed(k2, state, seen, m))


def sm_agreement(key: torch.Tensor, state: SimState, m: int, withhold=None, sig_valid=None,
                 received=None, collapsed: bool = False, strategies=None) -> dict:
    """SM(m) agreement and the 3f+1 quorum: ``om1_agreement``'s dict."""
    majorities = sm_round(key, state, m, withhold, sig_valid, received, collapsed, strategies)
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
