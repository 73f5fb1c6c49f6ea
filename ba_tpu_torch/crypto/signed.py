"""Signed orders: the per-(instance, value) signature tables of the signed
SM(m) sweep (the table part of ``ba_tpu/crypto/signed.py``).

A commander utters at most V distinct claims and Ed25519 is
deterministic, so every signature the protocol can carry lives in one
``[B, V]`` table: each distinct signature is verified once, and a
general's round-1 value selects its verdict (``sig_valid_from_tables``).

Message encoding (MSG_LEN bytes): ``b"BAv1" || instance u32 LE || value
u8 || zero pad``; binding the instance id stops cross-instance replay.

Keys, signatures and verdicts are byte-identical with the reference's.
The host signs through the port's native signer (``ba_tpu_torch.native``)
and the table verify runs on the card through the Ed25519 kernels
(``crypto/ed25519.verify``: K7, K5, K4, K3), as the reference's
``BA_TPU_SIGN_DEVICE=0`` mode signs on the host and verifies on the TPU.
On a CPU device the same verify runs the kernels' plain versions.
``verify_host_exact`` is the native host verifier, the oracle the tests
hold the device verdicts against.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ba_tpu_torch import native
from ba_tpu_torch.core.state import resolve_device
from ba_tpu_torch.crypto import ed25519, oracle

MSG_LEN = 16
_MAGIC = b"BAv1"
VERIFY_CHUNK = 65536  # signatures a verify dispatch (``ba_tpu/crypto/signed.py:380``)
# Setup chunks when the host signs and the card verifies: the reference's
# host-sign mode (``bench.py:692-696``).  Device signing, when ported,
# runs one chunk, as the reference derives it from the sign route.
SETUP_CHUNKS = 2


def commander_keys(batch: int, seed: int = 0) -> tuple[list[bytes], np.ndarray]:
    """Deterministic per-instance commander keypairs: (secret keys as
    32-byte strings, public keys uint8 [B, 32])."""
    sks = [oracle.secret_from_seed(f"{seed}:{b}".encode()) for b in range(batch)]
    sk_arr = np.stack([np.frombuffer(s, np.uint8) for s in sks])
    return sks, native.publickey_batch(sk_arr)


def order_message(instance: int, value: int) -> bytes:
    """The signed claim: "commander of ``instance`` says ``value``"."""
    body = _MAGIC + int(instance).to_bytes(4, "little") + bytes([value & 0xFF])
    return body.ljust(MSG_LEN, b"\0")


def _value_table_msgs(B: int, n_values: int, base: int) -> np.ndarray:
    """``order_message`` over the [B, V] grid -> uint8 [B, V, MSG_LEN];
    row b binds instance ``base + b``."""
    msgs = np.zeros((B, n_values, MSG_LEN), np.uint8)
    msgs[:, :, 0:4] = np.frombuffer(_MAGIC, np.uint8)
    msgs[:, :, 4:8] = (
        np.arange(base, base + B, dtype="<u4").view(np.uint8).reshape(B, 1, 4)
    )
    msgs[:, :, 8] = np.arange(n_values, dtype=np.uint8)[None, :]
    return msgs


def sign_value_tables(sks: list[bytes], pks: np.ndarray, n_values: int = 2,
                      base: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``n_values`` signs per commander: msgs uint8 [B, V, MSG_LEN] and
    sigs uint8 [B, V, 64].  ``base`` offsets the bound instance ids."""
    B = len(sks)
    msgs = _value_table_msgs(B, n_values, base)
    sk_arr = np.stack([np.frombuffer(s, np.uint8) for s in sks])
    sigs = native.sign_batch(
        np.repeat(sk_arr, n_values, axis=0),
        np.repeat(np.asarray(pks, np.uint8), n_values, axis=0),
        msgs.reshape(B * n_values, MSG_LEN),
    )
    return msgs, sigs.reshape(B, n_values, 64)


def verify_host_exact(pks, msgs, sigs) -> np.ndarray:
    """Exact per-signature verification on the host -> bool [B, n] numpy:
    pks [B, 32], msgs [B, n, MSG_LEN], sigs [B, n, 64], the cofactorless
    RFC 8032 equation with h reduced mod L."""
    pks_np = np.asarray(pks, np.uint8)
    msgs_np = np.asarray(msgs, np.uint8)
    sigs_np = np.asarray(sigs, np.uint8)
    B, n = msgs_np.shape[:2]
    return native.verify_batch(
        np.repeat(pks_np, n, axis=0), msgs_np.reshape(B * n, -1), sigs_np.reshape(B * n, 64)
    ).reshape(B, n)


def sig_valid_from_tables(ok: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    """The [B, n] validity mask from per-value verdicts ok [B, V]: each
    general's round-1 value selects its commander's verdict (a select
    for V = 2, a gather otherwise)."""
    if ok.shape[1] == 2:
        return torch.where(received == 1, ok[:, 1:2], ok[:, 0:1])
    return torch.gather(ok, 1, received.long())


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """A uint8 array-like on ``dev``: a tensor on a device of that type is
    moved there (a no-op when it is there); host data goes up from pinned
    memory without blocking."""
    if isinstance(a, torch.Tensor) and a.device.type == dev.type:
        return a.to(dev)
    t = torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.uint8)))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def verify_received(pks, msgs, sigs, device=None) -> torch.Tensor:
    """Batched verification on ``device`` (the card unless given): pks
    [B, 32], msgs [B, n, MSG_LEN], sigs [B, n, 64] uint8 -> bool [B, n].

    The exact cofactorless verdict of every signature, as the oracle
    gives it (the reference's ``BA_TPU_VERIFY_RLC`` batch check is not
    ported).  Flattens to B * n lanes, verifies in chunks of
    ``VERIFY_CHUNK`` (the last at its own size: the kernels take any
    lane count) and reshapes back.  Nothing here waits for the card."""
    dev = resolve_device(device)
    pks, msgs, sigs = (_to_device(a, dev) for a in (pks, msgs, sigs))
    B, n = msgs.shape[:2]
    total = B * n
    pk_bn = pks[:, None, :].expand(B, n, 32).reshape(total, 32)
    msgs = msgs.reshape(total, -1)
    sigs = sigs.reshape(total, 64)
    if total <= VERIFY_CHUNK:
        return ed25519.verify(pk_bn, msgs, sigs).reshape(B, n)
    oks = [ed25519.verify(pk_bn[o:o + VERIFY_CHUNK], msgs[o:o + VERIFY_CHUNK],
                          sigs[o:o + VERIFY_CHUNK])
           for o in range(0, total, VERIFY_CHUNK)]
    return torch.cat(oks).reshape(B, n)


def setup_signed_tables(batch: int, seed: int = 0, device=None):
    """One key-set's setup, signing on the host while the card verifies:
    keys, 2 signs per commander, and the table verify ->
    ``(sks, pks, msgs_t, sigs_t, ok, timings)``.

    The overlapped form of ``ba_tpu/crypto/signed.py::
    setup_signed_tables_overlapped`` in its host-sign mode: the batch is
    cut into ``SETUP_CHUNKS`` chunks; chunk c's tables go up to the card
    and its verify is queued, and the host signs chunk c+1 while the card
    works.  No step waits for the card until one fetch of the verdicts at
    the end.

    ``ok`` is bool [B, 2] on ``device`` (the card unless given).
    ``timings``: ``keys_s``, ``sign_s`` (host signing), ``drain_s`` (from
    the last queued verify to the verdicts on the host: the part of the
    verify not hidden behind signing), ``total_s``, ``chunks`` (the
    verify dispatches), ``device_sign`` (False: the host signs) and
    ``verify_route`` ("device" on the card, "plain" where the plain
    versions ran).
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    sks, pks = commander_keys(batch, seed)
    t_keys = time.perf_counter()
    per = -(-batch // SETUP_CHUNKS)
    sign_s = 0.0
    msgs_parts, sigs_parts, oks = [], [], []
    for lo in range(0, batch, per):
        hi = min(batch, lo + per)
        t0 = time.perf_counter()
        m_c, s_c = sign_value_tables(sks[lo:hi], pks[lo:hi], base=lo)
        sign_s += time.perf_counter() - t0
        msgs_parts.append(m_c)
        sigs_parts.append(s_c)
        oks.append(verify_received(pks[lo:hi], m_c, s_c, dev))
    t_queued = time.perf_counter()
    ok = torch.cat(oks) if len(oks) > 1 else oks[0]
    ok.cpu()  # the one fetch: drains the verify queue
    t_end = time.perf_counter()
    timings = {
        "keys_s": t_keys - t_start,
        "sign_s": sign_s,
        "drain_s": t_end - t_queued,
        "total_s": t_end - t_start,
        "chunks": len(oks),
        "device_sign": False,
        "verify_route": "device" if dev.type == "cuda" else "plain",
    }
    return sks, pks, np.concatenate(msgs_parts), np.concatenate(sigs_parts), ok, timings
