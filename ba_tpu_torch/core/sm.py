"""SM(m): signed-message agreement, the exact relay and the collapsed one
(``ba_tpu/core/sm.py``).

- ``seen[b, i, v]`` (v in {RETREAT, ATTACK}) is general i's V-set; values
  enter it only through the commander's signed round-1 row.
- A relay round on the collapsed path draws, per receiver and value, one
  8-bit uniform against the threshold of the OR of k fair coins (k =
  alive traitors holding v), gated by the chain bound ``r < t`` (t =
  alive traitors, a faulty commander included); a value held by any
  honest general reaches every alive general.
- The exact relay (the default, ``collapsed=False``) builds the
  ``[B, n, n, 2]`` send cube of round r: an honest holder forwards every
  value it holds, a traitor holder where its coin (``coin_bits`` of
  ``fold_in(key, r)``) lets it, or its strategy's gate (``send_gate``), or
  where the ``withhold`` schedule does not stop it; a value no honest
  general held before round r needs r < t.
- ``choice(V)``: exactly one value -> that value, else UNDEFINED; the
  commander reports its own order.

Two key modes, as ``core/eig.py``'s: one key data ``[2]`` for the whole
batch (every draw one stream over the batch, ``coin_bits(key, (B, n, n,
2))``), or one key a row, ``[B, 2]`` (``signed_agreement_step``): row b
draws what a B = 1 exchange under its own key draws.  On the same keys
every draw and output is bit-exact with the JAX package.
"""

from __future__ import annotations

import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.om import round1_broadcast
from ba_tpu_torch.core.quorum import majority_counts, quorum_decision
from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED
from ba_tpu_torch.scenario.strategies import send_gate


def _shape(key: torch.Tensor, batch: int, shape) -> tuple:
    """A draw's shape: over the batch for one key ``[2]``, per row for
    keys ``[batch, 2]``."""
    return (batch, *shape) if key.dim() == 1 else tuple(shape)


def _initial_seen(state: SimState, received: torch.Tensor) -> torch.Tensor:
    """seen[b, i, v] after the commander's signed round-1 push."""
    vals = torch.stack([received == RETREAT, received == ATTACK], dim=-1)
    return vals & state.alive[..., None]


def sm_relay_rounds(key: torch.Tensor, state: SimState, seen: torch.Tensor, m: int,
                    withhold=None, strategies=None) -> torch.Tensor:
    """m exact relay rounds (``ba_tpu/core/sm.py:72``).  ``withhold``
    ([m, B, n, n, 2] bool) pins the traitors' (round, receiver, sender,
    value) withholding; ``strategies`` ([B, n] int8) gates their sends
    instead of the coins.  Returns the final seen masks."""
    if withhold is not None and strategies is not None:
        raise ValueError("withhold pins the full send cube; strategies cannot also apply")
    B, n = state.faulty.shape
    dev = state.device
    t = (state.faulty & state.alive).sum(-1)
    honest = state.alive & ~state.faulty
    for r in range(1, m + 1):
        if withhold is None:
            coins = rng.coin_bits(rng.fold_in(key, r), _shape(key, B, (n, n, 2)), torch.bool)
            if strategies is not None:
                coins = send_gate(strategies[:, None, :, None], coins,
                                  torch.arange(n, device=dev)[None, :, None, None],
                                  torch.arange(2, device=dev)[None, None, None, :])
        else:
            coins = ~withhold[r - 1]
        held_honest = (seen & honest[..., None]).any(dim=1)  # [B, 2]
        chain_ok = (r < t)[:, None] | held_honest
        faulty_sends = (seen[:, None] & coins & state.faulty[:, None, :, None]
                        & chain_ok[:, None, None, :])
        honest_sends = seen[:, None] & honest[:, None, :, None]
        sends = (faulty_sends | honest_sends) & state.alive[:, None, :, None]
        seen = (seen | sends.any(dim=2)) & state.alive[..., None]
    return seen


def sm_relay_rounds_collapsed(key: torch.Tensor, state: SimState, seen: torch.Tensor,
                              m: int) -> torch.Tensor:
    """m collapsed relay rounds; round r draws ``uniform_u8(fold_in(key, r),
    (B, n, 2))`` (``(n, 2)`` a row for keys ``[B, 2]``).  Returns the final
    seen masks."""
    B, n = state.faulty.shape
    traitor = state.faulty & state.alive
    honest = state.alive & ~state.faulty
    t = traitor.sum(-1)
    for r in range(1, m + 1):
        held_honest = (seen & honest[..., None]).any(dim=1)  # [B, 2]
        chain_ok = (r < t)[:, None] | held_honest
        k_cnt = (seen & traitor[..., None]).sum(dim=1)
        thresh = rng.or_coin_threshold8(k_cnt, chain_ok)
        u = rng.uniform_u8(rng.fold_in(key, r), _shape(key, B, (n, 2)))
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
    relay key; ``sig_valid`` drops unauthenticated round-1 values;
    ``strategies`` shape round 1 and the relay.  ``collapsed`` takes the
    O(B n) relay, which honours neither ``withhold`` nor strategies."""
    if collapsed and withhold is not None:
        raise ValueError("collapsed relay cannot honor a withhold schedule")
    if collapsed and strategies is not None:
        raise ValueError("collapsed relay is a fair-coin identity; strategies need the "
                         "exact per-(receiver, sender) cube")
    k1, k2 = rng.split(key).unbind(-2)
    if received is None:
        received = round1_broadcast(k1, state, strategies)
    seen = _initial_seen(state, received)
    if sig_valid is not None:
        seen = seen & sig_valid[..., None]
    if collapsed:
        seen = sm_relay_rounds_collapsed(k2, state, seen, m)
    else:
        seen = sm_relay_rounds(k2, state, seen, m, withhold, strategies)
    return sm_choice(state, seen)


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
