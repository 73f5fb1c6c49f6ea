"""Signed orders: the per-(instance, value) signature tables of the signed
SM(m) sweep (the table part of ``ba_tpu/crypto/signed.py``).

A commander utters at most V distinct claims and Ed25519 is
deterministic, so every signature the protocol can carry lives in one
``[B, V]`` table: each distinct signature is verified once, and a
general's round-1 value selects its verdict (``sig_valid_from_tables``).

Message encoding (MSG_LEN bytes): ``b"BAv1" || instance u32 LE || value
u8 || zero pad``; binding the instance id stops cross-instance replay.

Keys, signatures and verdicts are byte-identical with the reference's.
Signing and the table verify run on the host through the port's native
signer (``ba_tpu_torch.native``): on a TPU the reference signs and
verifies these tables on the device through its Ed25519 kernels, which
the port has no counterpart for yet (``timings["verify_route"]`` says
"host").  So the tables are the signed sweep's input here, and their
setup time is the host's, not comparable with the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ba_tpu_torch import native
from ba_tpu_torch.core.state import resolve_device
from ba_tpu_torch.crypto import oracle

MSG_LEN = 16
_MAGIC = b"BAv1"


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


def setup_signed_tables(batch: int, seed: int = 0, device=None):
    """One key-set's setup: keys, 2 signs per commander, and the table
    verify -> ``(sks, pks, msgs_t, sigs_t, ok, timings)``.

    ``ok`` is bool [B, 2] on ``device`` (the card unless given);
    ``timings`` holds ``keys_s``, ``sign_s``, ``verify_s`` and ``total_s``
    (host wall clock, the upload of ``ok`` included in ``verify_s``) and
    ``verify_route`` = "host".
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    sks, pks = commander_keys(batch, seed)
    t_keys = time.perf_counter()
    msgs_t, sigs_t = sign_value_tables(sks, pks)
    t_sign = time.perf_counter()
    ok = torch.from_numpy(verify_host_exact(pks, msgs_t, sigs_t)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    timings = {
        "keys_s": t_keys - t_start,
        "sign_s": t_sign - t_keys,
        "verify_s": t_end - t_sign,
        "total_s": t_end - t_start,
        "verify_route": "host",
    }
    return sks, pks, msgs_t, sigs_t, ok, timings
