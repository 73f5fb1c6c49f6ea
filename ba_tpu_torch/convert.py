"""Carry state across packages as numpy arrays.

Arrays from the JAX package (``np.asarray`` of its jax arrays, or any
object with the same field names) become the port's carry, and back:
``SimState``, ``KeySchedule`` (key data + counter; one key a slot for
a coalesced batch), the strategy plane, counter blocks (per slot for a
coalesced batch), ``ScenarioBlock`` planes, the signed engine's table
verdicts, and Ed25519 field elements and points.  The tests feed both packages the same carry through here.
Numpy dtypes follow the reference: order int8, leader int32, faulty /
alive bool, ids int32, key data uint32, counter int32, field limbs int32.

Key data is the one place the two packages hold a value differently: the
port keeps the two uint32 words as int64 (``KeySchedule``), the JAX
package and the checkpoint file as uint32.  :func:`key_data_to_numpy` and
:func:`key_from_numpy` are that rule, both ways; the checkpoint writer
(:func:`carry_to_numpy`) and the run id's material use it.
"""

from __future__ import annotations

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.crypto import ed25519
from ba_tpu_torch.parallel.pipeline import KeySchedule
from ba_tpu_torch.scenario.compile import ScenarioBlock, SparseScenarioBlock

_STATE_DTYPES = {
    "order": (np.int8, torch.int8),
    "leader": (np.int32, torch.int32),
    "faulty": (np.bool_, torch.bool),
    "alive": (np.bool_, torch.bool),
    "ids": (np.int32, torch.int32),
}


def _tensor(array, dtype: torch.dtype, device=None) -> torch.Tensor:
    """An owned, contiguous tensor copy of ``array`` on ``device``."""
    return torch.tensor(np.asarray(array), dtype=dtype, device=resolve_device(device))


def state_from_numpy(src, device=None) -> SimState:
    """A SimState from any object with order / leader / faulty / alive /
    ids attributes (e.g. the JAX package's SimState)."""
    return SimState(
        **{
            name: _tensor(np.asarray(getattr(src, name)).astype(np_t), torch_t, device)
            for name, (np_t, torch_t) in _STATE_DTYPES.items()
        }
    )


def tables_from_numpy(pks, msgs, sigs, ok, device=None):
    """Signature tables of the JAX package (any array-likes) as the port
    holds them: ``(pks, msgs, sigs)`` as owned uint8 numpy arrays (they
    stay on the host, where the signer and the table verify run) and the
    verdicts ``ok`` as a bool tensor on ``device``."""
    host = tuple(np.array(np.asarray(a), dtype=np.uint8) for a in (pks, msgs, sigs))
    return (*host, _tensor(np.asarray(ok).astype(np.bool_), torch.bool, device))


def state_to_numpy(state: SimState) -> dict:
    return {
        name: getattr(state, name).cpu().numpy().astype(np_t)
        for name, (np_t, _) in _STATE_DTYPES.items()
    }


def key_from_numpy(key_data, device=None) -> torch.Tensor:
    """Key data (two uint32 words) as the port's int64 key tensor."""
    return _tensor(np.asarray(key_data, np.uint32).astype(np.int64), torch.int64, device)


def key_data_to_numpy(key_data: torch.Tensor) -> np.ndarray:
    """The port's key data (int64 words, any device) as the JAX package
    and the checkpoint file hold it: uint32 ``[..., 2]``."""
    return key_data.cpu().numpy().astype(np.uint32)


def schedule_from_numpy(key_data, counter, device=None) -> KeySchedule:
    return KeySchedule(
        key_from_numpy(key_data, device),
        _tensor(np.int32(counter), torch.int32, device),
    )


def schedule_to_numpy(sched: KeySchedule):
    """(key data uint32 [2], counter int32)."""
    return key_data_to_numpy(sched.key_data), np.int32(sched.counter.cpu().numpy())


def carry_to_numpy(state: SimState, sched: KeySchedule, counters=None, strategy=None) -> dict:
    """A carry (tensors on any device, pinned host copies included) as a
    carry checkpoint's arrays, in the file's order and dtypes: the state
    planes, ``key_data`` uint32 ``[2]``, ``counter`` a 0-d int32, then
    ``counters`` int32 and ``strategy`` int8 where the carry has them.
    Host tensors are viewed, not copied, where the dtype already fits."""
    def host(t, dtype):
        return t.cpu().numpy().astype(dtype, copy=False)

    arrays = {name: host(getattr(state, name), np_t)
              for name, (np_t, _) in _STATE_DTYPES.items()}
    arrays["key_data"] = key_data_to_numpy(sched.key_data)
    arrays["counter"] = np.asarray(host(sched.counter, np.int32)).reshape(())
    if counters is not None:
        arrays["counters"] = host(counters, np.int32)
    if strategy is not None:
        arrays["strategy"] = host(strategy, np.int8)
    return arrays


def carry_from_numpy(arrays: dict, device=None):
    """A checkpoint's arrays as the port's carry on ``device``: ``(state,
    schedule, counters or None, strategy or None)``, each tensor owned."""
    state = SimState(**{name: _tensor(np.asarray(arrays[name]).astype(np_t), torch_t, device)
                        for name, (np_t, torch_t) in _STATE_DTYPES.items()})
    sched = schedule_from_numpy(arrays["key_data"], arrays["counter"], device)
    counters = arrays.get("counters")
    strategy = arrays.get("strategy")
    return (state, sched,
            None if counters is None else counters_from_numpy(counters, device),
            None if strategy is None else strategy_from_numpy(strategy, device))


def slot_schedule_from_numpy(key_data, counter, device=None) -> KeySchedule:
    """A slot schedule (one base key a slot): key data uint32 ``[B, 2]``."""
    key_data = np.asarray(key_data)
    if key_data.ndim != 2 or key_data.shape[1] != 2:
        raise ValueError(f"slot key data must be [B, 2], got {key_data.shape}")
    return schedule_from_numpy(key_data, counter, device)


def slot_counters_from_numpy(block, device=None) -> torch.Tensor:
    """Per-slot counter blocks, int32 ``[B, C]`` (C = 3, or 5 in scenario
    mode)."""
    block = np.asarray(block)
    if block.ndim != 2 or block.shape[1] not in (3, 5):
        raise ValueError(f"slot counters must be [B, 3] or [B, 5], got {block.shape}")
    return counters_from_numpy(block, device)


def strategy_from_numpy(plane, device=None) -> torch.Tensor:
    return _tensor(np.asarray(plane).astype(np.int8), torch.int8, device)


def counters_from_numpy(block, device=None) -> torch.Tensor:
    return _tensor(np.asarray(block).astype(np.int32), torch.int32, device)


def events_from_numpy(chunk: dict, device=None) -> dict:
    """A dict of ``[R, B, n]`` event planes as the megasteps take them."""
    dtypes = {"kill": torch.bool, "revive": torch.bool,
              "set_faulty": torch.int8, "set_strategy": torch.int8}
    return {name: _tensor(chunk[name], dt, device) for name, dt in dtypes.items()}


def verdicts_from_numpy(ok, device=None) -> torch.Tensor:
    """Table verdicts as the signed engine takes them: bool ``[B, V]`` for
    one round (``signed_agreement_step``) or ``[R, B, V]`` planes (the
    signed megasteps)."""
    return _tensor(np.asarray(ok).astype(np.bool_), torch.bool, device)


def block_from_numpy(block):
    """The port's ScenarioBlock / SparseScenarioBlock for a block of the
    JAX package (dense planes copied; sparse blocks via their JSON doc)."""
    if hasattr(block, "to_doc"):
        return SparseScenarioBlock.from_doc(block.to_doc())
    return ScenarioBlock(
        kill=np.asarray(block.kill, bool),
        revive=np.asarray(block.revive, bool),
        set_faulty=np.asarray(block.set_faulty, np.int8),
        set_strategy=np.asarray(block.set_strategy, np.int8),
    )


def field_from_limbs22(limbs, device=None) -> torch.Tensor:
    """Field elements of the JAX package ([..., 22] int32, 12-bit signed
    limbs, any carried form) as the port's plain field holds them: the
    same limbs, an int32 tensor on ``device``."""
    a = np.asarray(limbs)
    if a.shape[-1:] != (22,):
        raise ValueError(f"expected [..., 22] limbs, got {a.shape}")
    return _tensor(a.astype(np.int32), torch.int32, device)


def point_from_limbs22(point, device=None) -> torch.Tensor:
    """A point of the JAX package ((X, Y, Z, T), each [..., 22] limbs) as
    the kernels take it: uint8 [..., 4, 32], the canonical encodings."""
    return ed25519.encode_point(tuple(field_from_limbs22(c, device) for c in point))
