"""Checkpoints on disk (``ba_tpu/utils/snapshot.py``): SimState files,
cluster snapshots, carry checkpoints and search checkpoints.

A **cluster snapshot** is the interactive cluster (roster, leader, round
counter, seed, backend configuration) as the JAX package's JSON document,
so ``--state FILE`` files cross between the packages both ways.  The
configuration names the backend class as that format does: the port's
``TorchBackend`` is written as the format's name for the batched device
backend, ``"JaxBackend"`` (:data:`CLUSTER_BACKEND_NAMES`), and a cuda and
a torch backend write the same configuration.

A **carry checkpoint** is the pipelined engine's carry — SimState,
KeySchedule (key data and round counter), the counter block, the live
strategy plane, the round cursor — as one versioned ``.npz`` whose
``__meta__`` entry holds a JSON header.  The format is the JAX package's
(``"ba_tpu.carry_checkpoint"``, version 1): the arrays keep its dtypes
(key data uint32 ``[2]``, counter a 0-d int32) and the header its keys,
so a file written by either package resumes in the other.  This module
is numpy and the stdlib only: ``python -m ba_tpu_torch.scenario``
validates checkpoints without touching torch's device side.

Every write is atomic (temp file, fsync, ``os.replace``, fsync of the
directory): a crash mid-save never corrupts the only good copy.  The
reader recomputes a sha256 over every array (:func:`content_digest`)
and refuses a file whose bytes changed.  A **search checkpoint** is an
adversary hunt's state, plain JSON under the same versioned-header and
digest discipline (:func:`write_search_checkpoint`).
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np

CARRY_CHECKPOINT_FORMAT = "ba_tpu.carry_checkpoint"
CARRY_CHECKPOINT_VERSION = 1

# SimState fields in carry order, then the KeySchedule pair; `counters`
# and `strategy` ride only on scenario / with_counters carries (the
# header says which).
CARRY_STATE_FIELDS = ("order", "leader", "faulty", "alive", "ids")
CARRY_SCHED_FIELDS = ("key_data", "counter")

CLUSTER_SNAPSHOT_VERSION = 1
# Backend class names as a cluster snapshot writes them: the format's name
# for the batched device backend is the JAX package's class name.
CLUSTER_BACKEND_NAMES = {"TorchBackend": "JaxBackend"}

# Sidecar suffixes that travel with a checkpoint: retention and
# quarantine move or remove them together with their checkpoint.
CHECKPOINT_COMPANION_SUFFIXES = (".rows.npz",)


def _atomic_write(path: str, write_fn, durable: bool = True) -> None:
    """``write_fn(tmp)`` then rename onto ``path``.  A reader sees the old
    file or the new one, never a torn one.  With ``durable`` the data is
    fsynced before the rename and the directory after it, so the rename
    survives a whole-system crash; derived data (the supervisor's rows
    sidecars, which fail their own schema check when garbled) skips both
    with ``durable=False``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        if durable:
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(tmp, path)
        if not durable:
            return
        try:  # best effort: some platforms refuse directory fds
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        except OSError:
            pass
        else:
            try:
                os.fsync(dfd)
            except OSError:
                pass
            finally:
                os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_sim_state(path: str, state, **extra_arrays) -> None:
    """SimState (tensors on any device) and extra named arrays -> one
    ``.npz`` file."""

    def host(t):
        return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)

    def write(tmp):
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                **{name: host(getattr(state, name)) for name in CARRY_STATE_FIELDS},
                **{k: host(v) for k, v in extra_arrays.items()},
            )

    _atomic_write(path, write)


def load_sim_state(path: str, device=None):
    """``.npz`` -> (SimState on ``device``, dict of the extra numpy
    arrays).  ``device`` follows the port's rule: the card unless
    ``"cpu"`` is asked for."""
    import torch

    from ba_tpu_torch.core.state import SimState, resolve_device

    dev = resolve_device(device)
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    state = SimState(*(torch.tensor(fields.pop(name), device=dev)
                       for name in CARRY_STATE_FIELDS))
    return state, fields


def _backend_config(cluster) -> dict:
    """Protocol-defining backend attributes (class + flags when present)."""
    b = cluster.backend
    name = type(b).__name__
    return {
        "backend": CLUSTER_BACKEND_NAMES.get(name, name),
        "protocol": getattr(b, "protocol", "om"),
        "m": getattr(b, "m", 1),
        "signed": getattr(b, "signed", False),
    }


def save_cluster(path: str, cluster) -> None:
    """Interactive Cluster -> JSON (roster, leader, round counter, seed,
    backend configuration), atomically."""
    doc = {
        "version": CLUSTER_SNAPSHOT_VERSION,
        "seed": cluster.seed,
        "round": cluster._round,
        "next_id": cluster._next_id,
        "leader_id": cluster.leader_id,
        "config": _backend_config(cluster),
        "generals": [
            {"id": g.id, "port": g.port, "faulty": g.faulty, "alive": g.alive}
            for g in cluster.generals
        ],
    }

    def write(tmp):
        with open(tmp, "w") as fh:
            json.dump(doc, fh)

    _atomic_write(path, write)


def restore_cluster(path: str, cluster) -> None:
    """Load a JSON snapshot into an existing Cluster (backend unchanged).

    Refuses a snapshot whose recorded backend configuration differs from
    the running cluster's: a resumed session must not silently switch
    protocol, recursion depth, signing or backend.
    """
    from ba_tpu_torch.runtime.cluster import General

    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != CLUSTER_SNAPSHOT_VERSION:
        raise ValueError(f"unknown cluster snapshot version in {path!r}")
    want = doc.get("config")
    have = _backend_config(cluster)
    if want is not None and want != have:
        raise ValueError(
            f"snapshot {path!r} was taken with backend config {want}, "
            f"but this run uses {have}; relaunch with matching flags"
        )
    cluster.seed = doc["seed"]
    cluster._round = doc["round"]
    cluster._next_id = doc["next_id"]
    cluster.leader_id = doc["leader_id"]
    cluster.generals = [General(**g) for g in doc["generals"]]


# -- search checkpoints ----------------------------------------------------------

SEARCH_STATE_FORMAT = "ba_tpu.search_state"
SEARCH_STATE_VERSION = 1


def _search_state_digest(state: dict) -> str:
    """sha256 over the canonical JSON of a search-state payload (sorted
    keys): the pure-JSON twin of :func:`content_digest`."""
    return hashlib.sha256(json.dumps(state, sort_keys=True).encode()).hexdigest()


def write_search_checkpoint(path: str, state: dict, **meta) -> None:
    """Search-state payload and meta -> one atomic, versioned JSON file,
    the JAX package's format (``"ba_tpu.search_state"``, version 1), so a
    hunt checkpointed by either package resumes in the other.  ``meta``
    keys ride the header beside the format's own (``run_id`` above all);
    the digest is computed, never taken from ``meta``."""
    doc = {
        "format": SEARCH_STATE_FORMAT,
        "v": SEARCH_STATE_VERSION,
        **meta,
        "sha256": _search_state_digest(state),
        "state": state,
    }

    def write(tmp):
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")

    _atomic_write(path, write)


def read_search_checkpoint(path: str):
    """JSON file -> ``(meta, state dict)``.  Raises ``ValueError`` on an
    unknown format or version, a missing payload, or a digest mismatch:
    anything that could resume the wrong hunt."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path!r}: not valid JSON ({e})") from None
    if not isinstance(doc, dict) or doc.get("format") != SEARCH_STATE_FORMAT:
        raise ValueError(
            f"{path!r}: format {doc.get('format') if isinstance(doc, dict) else doc!r} "
            f"is not {SEARCH_STATE_FORMAT!r}")
    if doc.get("v") != SEARCH_STATE_VERSION:
        raise ValueError(f"{path!r}: search state version {doc.get('v')!r} "
                         f"(this build reads v{SEARCH_STATE_VERSION})")
    state = doc.get("state")
    if not isinstance(state, dict):
        raise ValueError(f"{path!r}: search state payload missing")
    want = doc.get("sha256")
    got = _search_state_digest(state)
    if want != got:
        raise ValueError(
            f"{path!r}: content digest mismatch (stored {str(want)[:12]}..., recomputed "
            f"{got[:12]}...) — the search checkpoint is corrupt; refusing to resume from it")
    meta = {k: v for k, v in doc.items() if k not in ("state", "sha256")}
    return meta, state


def content_digest(arrays: dict) -> str:
    """sha256 over every array's name, dtype, shape and raw bytes, in name
    order.  The dtype's name is hashed, so the same values under another
    dtype are another digest."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def write_carry_checkpoint(path: str, arrays: dict, meta: dict) -> None:
    """Host numpy arrays and a JSON-able header -> one atomic versioned
    ``.npz``.  The header gains the format, the version and the
    ``sha256`` content digest (computed, last, so caller meta cannot mask
    it) and is stored as the ``__meta__`` entry, a unicode scalar that
    loads without pickle."""
    meta = {
        "format": CARRY_CHECKPOINT_FORMAT,
        "v": CARRY_CHECKPOINT_VERSION,
        **meta,
        "sha256": content_digest(arrays),
    }

    def write(tmp):
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                __meta__=np.asarray(json.dumps(meta)),
                **{k: np.asarray(v) for k, v in arrays.items()},
            )

    _atomic_write(path, write)


def read_carry_checkpoint(path: str):
    """``.npz`` -> ``(meta, {name: numpy array})`` after schema checks.

    Raises ``ValueError`` on anything that could resume the wrong
    campaign: an unreadable file, an unknown format or version, a digest
    mismatch, missing carry arrays, a round cursor that disagrees with
    the stored KeySchedule counter, malformed state planes or shard
    layout, or counters / strategy planes that do not fit the state.
    """
    try:
        with np.load(path, allow_pickle=False) as data:
            fields = {k: data[k] for k in data.files}
    except zipfile.BadZipFile as e:
        # a truncated or half-written file: the documented ValueError
        raise ValueError(f"{path!r}: not a readable .npz ({e})") from None
    raw = fields.pop("__meta__", None)
    if raw is None:
        raise ValueError(f"{path!r}: no __meta__ entry — not a carry checkpoint")
    try:
        meta = json.loads(str(raw))
    except ValueError as e:
        raise ValueError(f"{path!r}: unparseable __meta__ ({e})") from None
    if meta.get("format") != CARRY_CHECKPOINT_FORMAT:
        raise ValueError(
            f"{path!r}: format {meta.get('format')!r} is not "
            f"{CARRY_CHECKPOINT_FORMAT!r}"
        )
    if meta.get("v") != CARRY_CHECKPOINT_VERSION:
        raise ValueError(
            f"{path!r}: carry checkpoint version {meta.get('v')!r} "
            f"(this build reads v{CARRY_CHECKPOINT_VERSION})"
        )
    want_digest = meta.get("sha256")
    if want_digest is not None:  # files from before the digest still read
        got = content_digest(fields)
        if got != want_digest:
            raise ValueError(
                f"{path!r}: content digest mismatch (stored "
                f"{want_digest[:12]}..., recomputed {got[:12]}...) — the "
                f"checkpoint is corrupt; refusing to resume from it"
            )
    missing = [k for k in CARRY_STATE_FIELDS + CARRY_SCHED_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"{path!r}: missing carry arrays {missing}")
    rnd = meta.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        raise ValueError(f"{path!r}: bad round cursor {rnd!r}")
    if int(fields["counter"]) != rnd:
        raise ValueError(
            f"{path!r}: round cursor {rnd} disagrees with the KeySchedule "
            f"counter {int(fields['counter'])} — the carry would replay "
            f"the wrong key stream"
        )
    if fields["faulty"].shape != fields["alive"].shape or fields["faulty"].ndim != 2:
        raise ValueError(
            f"{path!r}: state planes malformed "
            f"(faulty {fields['faulty'].shape}, alive {fields['alive'].shape})"
        )
    layout = meta.get("shard_layout")
    if layout is not None and (
        not isinstance(layout, dict)
        or not layout
        or not all(isinstance(k, str) and isinstance(v, int) and v >= 1
                   for k, v in layout.items())
    ):
        raise ValueError(
            f"{path!r}: malformed shard_layout {layout!r} (want "
            f"{{axis: devices >= 1}})"
        )
    names = meta.get("counter_names")
    if "counters" in fields:
        if not isinstance(names, list) or len(names) != fields["counters"].shape[-1]:
            raise ValueError(
                f"{path!r}: counters block has {fields['counters'].shape} "
                f"entries but counter_names is {names!r}"
            )
    if "strategy" in fields and fields["strategy"].shape != fields["faulty"].shape:
        raise ValueError(
            f"{path!r}: strategy plane {fields['strategy'].shape} does not "
            f"match the state {fields['faulty'].shape}"
        )
    if meta.get("scenario") and ("counters" not in fields or "strategy" not in fields):
        raise ValueError(f"{path!r}: scenario carry without counters/strategy planes")
    return meta, fields


def validate_carry_checkpoint(path: str) -> dict:
    """Schema-check a carry checkpoint; returns its header."""
    meta, _ = read_carry_checkpoint(path)
    return meta


# -- retention and recovery scans ---------------------------------------------
#
# A ``{round}``-templated checkpoint path names a family of files: list
# it, prune it, and find the newest member that still validates,
# quarantining corrupt ones to ``<path>.corrupt`` so a damaged file is
# diagnosed once instead of blocking every later scan.


def checkpoint_paths(template: str) -> list:
    """Every checkpoint of a ``{round}``-templated path on disk, as
    ``[(round, path)]`` oldest first.  The basename's ``{round}`` slot
    must be digits, so ``.tmp.<pid>`` strays and ``.corrupt`` files never
    join the family."""
    if "{round}" not in template:
        raise ValueError(f"checkpoint template {template!r} has no {{round}}")
    dirname, base = os.path.split(template)
    if "{round}" in dirname:
        raise ValueError(
            f"{{round}} must be in the filename, not the directory ({template!r})"
        )
    prefix, suffix = base.split("{round}", 1)
    out = []
    try:
        names = os.listdir(dirname or ".")
    except OSError:
        return []
    for name in names:
        if not (name.startswith(prefix) and name.endswith(suffix)):
            continue
        mid = name[len(prefix):len(name) - len(suffix)]
        if mid.isdigit():
            out.append((int(mid), os.path.join(dirname, name)))
    out.sort()
    return out


def _remove_companions(path: str) -> None:
    for suffix in CHECKPOINT_COMPANION_SUFFIXES:
        side = path + suffix
        if os.path.exists(side):
            try:
                os.remove(side)
            except OSError:
                pass


def prune_checkpoints(template: str, keep_last: int, companions: bool = True) -> list:
    """Delete all but the ``keep_last`` newest checkpoints of a
    ``{round}``-templated family, with their sidecars unless
    ``companions=False`` (the supervisor keeps its rows sidecars: they
    are the campaign's history).  Returns the removed paths.  Never
    raises on a racing writer or reader."""
    if keep_last < 1:
        raise ValueError(f"keep_last={keep_last} must be >= 1")
    removed = []
    for _, path in checkpoint_paths(template)[:-keep_last]:
        try:
            os.remove(path)
        except OSError:
            continue
        if companions:
            _remove_companions(path)
        removed.append(path)
    return removed


def quarantine_checkpoint(path: str) -> str:
    """Move a corrupt checkpoint (and its sidecars) to ``<path>.corrupt``,
    keeping its bytes for a post-mortem.  Returns the new path."""
    target = path + ".corrupt"
    os.replace(path, target)
    for suffix in CHECKPOINT_COMPANION_SUFFIXES:
        side = path + suffix
        if os.path.exists(side):
            try:
                os.replace(side, side + ".corrupt")
            except OSError:
                pass
    return target


def newest_valid_checkpoint(path_or_template: str, quarantine: bool = True,
                            below: int | None = None, accept=None):
    """The newest checkpoint that passes the full schema and digest checks.

    Scans a ``{round}``-templated family newest first (a plain path is a
    family of one); a member that fails :func:`read_carry_checkpoint` is
    quarantined (when ``quarantine``) and the scan falls back to the next
    one.  ``below`` skips members at round cursors >= it without
    quarantining them (valid, only not resumable); ``accept(meta) ->
    bool`` skips members the same way.  Returns ``(path, meta)`` or
    ``None``.
    """
    if "{round}" in path_or_template:
        members = checkpoint_paths(path_or_template)
        if below is not None:
            members = [(r, p) for r, p in members if r < below]
        candidates = [p for _, p in reversed(members)]
    else:
        candidates = [path_or_template] if os.path.exists(path_or_template) else []
    for path in candidates:
        try:
            meta = validate_carry_checkpoint(path)
        except (OSError, ValueError):
            if quarantine:
                try:
                    quarantine_checkpoint(path)
                except OSError:
                    pass
            continue
        if below is not None and meta.get("round", 0) >= below:
            continue  # a filename that lied about its cursor: skip, keep
        if accept is not None and not accept(meta):
            continue
        return path, meta
    return None
