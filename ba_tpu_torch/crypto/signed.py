"""Signed orders: the per-(instance, value) signature tables of the signed
SM(m) sweep (the table part of ``ba_tpu/crypto/signed.py``).

A commander utters at most V distinct claims and Ed25519 is
deterministic, so every signature the protocol can carry lives in one
``[B, V]`` table: each distinct signature is verified once, and a
general's round-1 value selects its verdict (``sig_valid_from_tables``).

Message encoding (MSG_LEN bytes): ``b"BAv1" || instance u32 LE || value
u8 || zero pad``; binding the instance id stops cross-instance replay.

Keys, signatures and verdicts are byte-identical with the reference's.
The setup signs on the card by default (``sign_value_tables_device``:
``crypto/ed25519.sign``, through K5', K5, K4, K8 and K6), as the
reference's TPU default does, or on the host through the port's native
signer (``ba_tpu_torch.native``), the reference's ``BA_TPU_SIGN_DEVICE=0``
mode; either way the table verify runs on the card through
``crypto/ed25519.verify`` (K7, K5, K4, K3).  On a CPU device the same
functions run the kernels' plain versions.  ``verify_host_exact`` is the
native host verifier, the oracle the tests hold the device verdicts
against.
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
# Setup chunks by sign route, as the reference derives them
# (``bench.py:692-696``): the host signs chunk c + 1 while the card
# verifies chunk c; device signing has nothing to overlap, so one chunk.
SETUP_CHUNKS = 2
DEVICE_SIGN_CHUNKS = 1


def secret_rows(sks: list[bytes]) -> np.ndarray:
    """32-byte secret keys as uint8 [B, 32], in one copy (a stack of B
    one-row arrays takes ~1.4 us a key)."""
    return np.frombuffer(bytearray(b"".join(sks)), np.uint8).reshape(len(sks), 32)


def commander_keys(batch: int, seed: int = 0) -> tuple[list[bytes], np.ndarray]:
    """Deterministic per-instance commander keypairs: (secret keys as
    32-byte strings, public keys uint8 [B, 32])."""
    sks = [oracle.secret_from_seed(f"{seed}:{b}".encode()) for b in range(batch)]
    return sks, native.publickey_batch(secret_rows(sks))


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
    sk_arr = secret_rows(sks)
    sigs = native.sign_batch(
        np.repeat(sk_arr, n_values, axis=0),
        np.repeat(np.asarray(pks, np.uint8), n_values, axis=0),
        msgs.reshape(B * n_values, MSG_LEN),
    )
    return msgs, sigs.reshape(B, n_values, 64)


def sign_value_tables_device(sks: list[bytes], pks, n_values: int = 2, base: int = 0,
                             device=None) -> tuple[np.ndarray, torch.Tensor]:
    """``sign_value_tables`` with the signing on ``device`` (the card
    unless given) through ``ed25519.sign``: msgs uint8 [B, V, MSG_LEN] on
    the host and sigs uint8 [B, V, 64] on ``device``, byte-identical with
    the host signer's.  ``pks`` may already lie on ``device``.  Nothing
    here waits for the card: keys and messages go up from pinned memory."""
    dev = resolve_device(device)
    B = len(sks)
    msgs = _value_table_msgs(B, n_values, base)
    sk = _to_device(secret_rows(sks), dev).repeat_interleave(n_values, dim=0)
    pk = _to_device(pks, dev).repeat_interleave(n_values, dim=0)
    sigs = ed25519.sign(sk, pk, _to_device(msgs, dev).reshape(B * n_values, MSG_LEN))
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


def queue_signed_tables(batch: int, seed: int = 0, device=None,
                        sign_device: bool | None = None) -> dict:
    """One key-set's setup up to its one fetch: keys on the host, 2 signs
    per commander, and the table verify queued on ``device`` (the card
    unless given).  Nothing here waits for the card;
    :func:`drain_signed_tables` fetches.

    ``sign_device`` picks the sign route: ``None`` signs on the card when
    ``device`` is one, as the reference's auto mode signs on its
    accelerator (``ba_tpu/crypto/signed.py:654``); ``True`` signs with
    ``ed25519.sign`` on ``device`` (the plain versions on the CPU);
    ``False`` signs on the host with the native signer.  The chunk count
    follows from the route: ``DEVICE_SIGN_CHUNKS`` (1) on the device, the
    public keys uploaded once for sign and verify; ``SETUP_CHUNKS`` (2)
    on the host, chunk c's tables going up and its verify queued while
    the host signs chunk c + 1.
    """
    dev = resolve_device(device)
    if sign_device is None:
        sign_device = dev.type == "cuda"
    chunks = DEVICE_SIGN_CHUNKS if sign_device else SETUP_CHUNKS
    t_start = time.perf_counter()
    sks, pks = commander_keys(batch, seed)
    t_keys = time.perf_counter()
    pks_v = _to_device(pks, dev) if sign_device else pks
    per = -(-batch // chunks)
    sign_s = 0.0
    msgs_parts, sigs_parts, oks = [], [], []
    for lo in range(0, batch, per):
        hi = min(batch, lo + per)
        t0 = time.perf_counter()
        if sign_device:
            m_c, s_c = sign_value_tables_device(sks[lo:hi], pks_v[lo:hi], base=lo, device=dev)
        else:
            m_c, s_c = sign_value_tables(sks[lo:hi], pks[lo:hi], base=lo)
        sign_s += time.perf_counter() - t0
        msgs_parts.append(m_c)
        sigs_parts.append(s_c)
        oks.append(verify_received(pks_v[lo:hi], m_c, s_c, dev))
    return {"sks": sks, "pks": pks, "msgs": np.concatenate(msgs_parts), "sigs": sigs_parts,
            "oks": oks, "device": dev, "device_sign": sign_device, "sign_s": sign_s,
            "t_start": t_start, "t_keys": t_keys, "t_queued": time.perf_counter()}


def drain_signed_tables(queued: dict):
    """The one fetch of a queued setup: the verdicts, and with device
    signing the signature bytes in the same copy ->
    ``(sks, pks, msgs_t, sigs_t, ok, timings)``.

    ``ok`` is bool [B, 2] on the setup's device; ``sigs_t`` is on the
    host.  ``timings``: ``keys_s``, ``sign_s`` (host signing, or the host
    time to queue the device signing), ``drain_s`` (from the last queued
    dispatch to the verdicts and signatures on the host: the card's work
    not hidden behind the host's), ``total_s``, ``chunks``,
    ``device_sign`` and ``verify_route`` ("device" on the card, "plain"
    where the plain versions ran).
    """
    q = queued
    ok = torch.cat(q["oks"]) if len(q["oks"]) > 1 else q["oks"][0]
    if q["device_sign"]:
        sigs_dev = torch.cat(q["sigs"]) if len(q["sigs"]) > 1 else q["sigs"][0]
        batch, n = sigs_dev.shape[:2]
        both = torch.cat([ok.to(torch.uint8), sigs_dev.reshape(batch, n * 64)], dim=1)
        sigs = both.cpu().numpy()[:, n:].reshape(batch, n, 64)  # the one fetch
    else:
        ok.cpu()  # the one fetch: drains the verify queue
        sigs = np.concatenate(q["sigs"])
    t_end = time.perf_counter()
    timings = {
        "keys_s": q["t_keys"] - q["t_start"],
        "sign_s": q["sign_s"],
        "drain_s": t_end - q["t_queued"],
        "total_s": t_end - q["t_start"],
        "chunks": len(q["oks"]),
        "device_sign": q["device_sign"],
        "verify_route": "device" if q["device"].type == "cuda" else "plain",
    }
    return q["sks"], q["pks"], q["msgs"], sigs, ok, timings


def setup_signed_tables(batch: int, seed: int = 0, device=None,
                        sign_device: bool | None = None):
    """One key-set's setup: keys, 2 signs per commander and the table
    verify, with one fetch at the end -> ``(sks, pks, msgs_t, sigs_t, ok,
    timings)``: :func:`queue_signed_tables`, then
    :func:`drain_signed_tables`.  The form of ``ba_tpu/crypto/signed.py::
    setup_signed_tables_overlapped``; on the card it signs there by
    default, in one chunk, as the reference does on its accelerator.
    """
    return drain_signed_tables(queue_signed_tables(batch, seed, device, sign_device))
