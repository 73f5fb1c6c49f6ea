"""Signed orders: the per-(instance, value) signature tables of signed
SM(m) (``ba_tpu/crypto/signed.py``).

A commander utters at most V distinct claims and Ed25519 is
deterministic, so every signature the protocol can carry lives in one
``[B, V]`` table: each distinct signature is verified once, and a
general's round-1 value selects its verdict (``sig_valid_from_tables``).

The host tier (keys, the value and round-bound message grammars,
native batch signing, ``verify_host_exact``) lives in ``crypto/tables.py``,
which imports no torch, and is re-exported here.
:func:`verify_exact` is the exact verify by device: the native host
verifier for data on the CPU, K7, K5, K4 and K3 on the card (the
reference's ``_verify_received_exact``, whose platform probe and
``BA_TPU_VERIFY_NATIVE`` knob become the device argument).
:func:`sign_round1` and :func:`signed_sm_agreement` are the one-shot
signed round.

Keys, signatures and verdicts are byte-identical with the reference's.
The setup signs on the card by default (``sign_value_tables_device``:
``crypto/ed25519.sign``, through K5', K5, K4, K8 and K6), as the
reference's TPU default does, or on the host through the port's native
signer (``ba_tpu_torch.native``), the reference's ``BA_TPU_SIGN_DEVICE=0``
mode; either way the table verify runs on the card, by default through
``crypto/ed25519.verify`` (K7, K5, K4, K3), the exact verdict of every
signature.  ``verify="rlc"`` takes the reference's ``BA_TPU_VERIFY_RLC=1``
route instead: ``crypto/ed25519.verify_rlc``, one batch equation a chunk
(K7, K5, K6, K3', K4, K8), with the exact verify only for a chunk it
rejects.  On an H100 ``chip_smoke.py``'s config #3 phase measures the
batch check at 0.91x the per-signature rate at 65 536 lanes (7.43e6
against 8.17e6 verifies/s), and its setup phase the "rlc" setup within
a few milliseconds of the exact one; it is kept for parity with the
reference, whose accelerator it did speed up.  On a CPU device
the same functions run the kernels' plain versions.
``verify_host_exact`` is the native host verifier, the oracle the tests
hold the device verdicts against.
"""

from __future__ import annotations

import secrets
import time

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.crypto import ed25519
from ba_tpu_torch.crypto.tables import (
    MSG_LEN,
    _round_table_msgs,
    _sign_table_msgs,
    _value_table_msgs,
    commander_keys,
    key_table_arrays,
    order_message,
    round_message,
    secret_rows,
    sign_round_tables,
    sign_table_msgs_arrays,
    sign_value_tables,
    verify_host_exact,
)

# The host tier is re-exported: the reference's signed.py defines it.
__all__ = [
    "MSG_LEN", "_round_table_msgs", "_sign_table_msgs", "_value_table_msgs",
    "commander_keys", "key_table_arrays", "order_message", "round_message",
    "secret_rows", "sign_round_tables", "sign_table_msgs_arrays", "sign_value_tables",
    "verify_host_exact",
    "VERIFY_CHUNK", "SETUP_CHUNKS", "DEVICE_SIGN_CHUNKS", "VERIFY_ROUTES", "SIGN_DEVICE_ROUTES",
    "WARM_SEED", "sign_received", "sign_value_tables_device", "sig_valid_from_tables",
    "verify_received", "host_verify_route", "verify_exact", "fresh_rlc_coeffs", "rlc_batch_ok",
    "verify_received_rlc", "queue_signed_tables", "drain_signed_tables", "setup_signed_tables",
    "sign_on_device", "setup_signed_tables_overlapped", "warm_signed_tables", "sign_round1",
    "signed_sm_agreement", "signed_sm_agreement_sharded",
]

VERIFY_CHUNK = 65536  # signatures a verify dispatch (``ba_tpu/crypto/signed.py:380``)
# Setup chunks by sign route, as the reference derives them
# (``bench.py:692-696``): the host signs chunk c + 1 while the card
# verifies chunk c; device signing has nothing to overlap, so one chunk.
SETUP_CHUNKS = 2
DEVICE_SIGN_CHUNKS = 1
VERIFY_ROUTES = ("exact", "rlc")


def sign_received(sks: list[bytes], pks: np.ndarray, received: np.ndarray,
                  corrupt: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The signed round-1 values (``ba_tpu/crypto/signed.py:331``):
    received [B, n] in {0, 1} -> msgs uint8 [B, n, MSG_LEN] and sigs uint8
    [B, n, 64], entry (b, i) the commander of b's signed message for the
    value general i received, gathered from ``sign_value_tables``.
    ``corrupt`` ([B, n] bool) flips every bit of signature byte 0 where
    set: faults the verifier must reject."""
    received = np.asarray(received).astype(np.int64)
    if received.size and (received.min() < 0 or received.max() > 1):
        raise ValueError("round-1 values are 0 or 1")
    msgs_t, sigs_t = sign_value_tables(sks, pks)
    rows = np.arange(len(sks))[:, None]
    msgs, sigs = msgs_t[rows, received], sigs_t[rows, received]
    if corrupt is not None:
        sigs[..., 0] ^= np.where(corrupt, np.uint8(0xFF), np.uint8(0))
    return msgs, sigs


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


def _check_route(verify: str) -> None:
    if verify not in VERIFY_ROUTES:
        raise ValueError(f"verify must be one of {VERIFY_ROUTES}, got {verify!r}")


def verify_received(pks, msgs, sigs, device=None, verify: str = "exact") -> torch.Tensor:
    """Batched verification on ``device`` (the card unless given): pks
    [B, 32], msgs [B, n, MSG_LEN], sigs [B, n, 64] uint8 -> bool [B, n].

    ``verify="exact"`` (the default, as the reference's default):  the
    cofactorless verdict of every signature, as the oracle gives it.
    Flattens to B * n lanes, verifies in chunks of ``VERIFY_CHUNK`` (the
    last at its own size: the kernels take any lane count) and reshapes
    back.  Nothing here waits for the card.  ``verify="rlc"``: the batch
    check first, :func:`verify_received_rlc`, which fetches its verdict;
    on an H100 it runs 0.91x the exact route's rate (module docstring)."""
    _check_route(verify)
    if verify == "rlc":
        return verify_received_rlc(pks, msgs, sigs, device)
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


def host_verify_route(device=None) -> bool:
    """True when :func:`verify_exact` verifies on the host for ``device``
    (the card unless given): every device but a CUDA one."""
    return resolve_device(device).type != "cuda"


def verify_exact(pks, msgs, sigs, device=None) -> torch.Tensor:
    """The exact per-signature verdicts -> bool [B, n] on ``device`` (the
    card unless given): pks [B, 32], msgs [B, n, MSG_LEN], sigs [B, n,
    64].  On the card :func:`verify_received` (K7, K5, K4, K3; nothing
    waits for the card); on the CPU the native host verifier, the same
    verdicts in one C call.  A native library that cannot be built
    raises."""
    dev = resolve_device(device)
    if not host_verify_route(dev):
        return verify_received(pks, msgs, sigs, dev)
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in (pks, msgs, sigs)]
    return torch.from_numpy(verify_host_exact(*host)).to(dev)


def fresh_rlc_coeffs(total: int) -> np.ndarray:
    """Unpredictable 128-bit batch-verify coefficients, one a lane: uint8
    [total, 16] from OS entropy, never from a seed or the batch
    (``ba_tpu/crypto/signed.py:535``): the check is sound only if z is
    unknown to whoever chose the signatures."""
    return np.frombuffer(bytearray(secrets.token_bytes(total * 16)), np.uint8).reshape(total, 16)


def rlc_batch_ok(pks, msgs, sigs, device=None) -> torch.Tensor:
    """The chunked batch check, ``ed25519.verify_rlc``, on ``device``
    (the card unless given) -> a bool scalar on the device, "every
    signature valid", not fetched (``ba_tpu/crypto/signed.py:549``).

    pks [B, 32], msgs [B, n, MSG_LEN], sigs [B, n, 64]: instance b's n
    lanes share its key, so ``pk_group`` is n.  Chunks hold whole groups,
    up to ``VERIFY_CHUNK`` lanes; a call smaller than a chunk runs at its
    own size, and a ragged tail is padded with copies of the first group,
    which cannot turn a reject into an accept (a valid copy adds nothing,
    an invalid one rejects).  Fresh coefficients for every call."""
    dev = resolve_device(device)
    pks, msgs, sigs = (_to_device(a, dev) for a in (pks, msgs, sigs))
    B, n = msgs.shape[:2]
    total = B * n
    pk_bn = pks[:, None, :].expand(B, n, 32).reshape(total, 32)
    msgs = msgs.reshape(total, -1)
    sigs = sigs.reshape(total, 64)
    chunk = min(max(n, VERIFY_CHUNK // n * n), total)
    reps = (-total) % chunk // n
    if reps:
        pk_bn, msgs, sigs = (torch.cat([t, t[:n].repeat(reps, 1)]) for t in (pk_bn, msgs, sigs))
    z = _to_device(fresh_rlc_coeffs(pk_bn.shape[0]), dev)
    oks = [ed25519.verify_rlc(pk_bn[o:o + chunk], msgs[o:o + chunk], sigs[o:o + chunk],
                              z[o:o + chunk], pk_group=n)[0]
           for o in range(0, pk_bn.shape[0], chunk)]
    return oks[0] if len(oks) == 1 else torch.stack(oks).all()


def verify_received_rlc(pks, msgs, sigs, device=None) -> torch.Tensor:
    """Batched verification through the batch check, with the exact
    per-signature verify on a reject -> bool [B, n] on ``device``
    (``ba_tpu/crypto/signed.py:610``).  Fetches the batch verdict.

    Where it differs from the exact route, as in the reference: the batch
    check is cofactored, so a signer's own torsion-malleated signature is
    accepted here when every other lane is valid, and rejected by the
    exact verify when any lane is not."""
    dev = resolve_device(device)
    B, n = np.shape(msgs)[:2]
    if bool(rlc_batch_ok(pks, msgs, sigs, dev)):
        return torch.ones((B, n), dtype=torch.bool, device=dev)
    return verify_received(pks, msgs, sigs, dev)


def queue_signed_tables(batch: int, seed: int = 0, device=None,
                        sign_device: bool | None = None, verify: str = "exact") -> dict:
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

    ``verify`` picks the table verify: ``"exact"`` (the default) verifies
    every signature; ``"rlc"`` queues one batch check a chunk
    (:func:`rlc_batch_ok`), whose verdicts come back in the one fetch,
    as the reference's ``BA_TPU_VERIFY_RLC=1`` setup does
    (``ba_tpu/crypto/signed.py:727-775``); on an H100 it saves nothing
    (module docstring).
    """
    _check_route(verify)
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
        if verify == "rlc":
            oks.append(rlc_batch_ok(pks_v[lo:hi], m_c, s_c, dev))
        else:
            oks.append(verify_received(pks_v[lo:hi], m_c, s_c, dev))
    return {"sks": sks, "pks": pks, "pks_v": pks_v, "msgs": msgs_parts, "sigs": sigs_parts,
            "oks": oks, "verify": verify, "device": dev, "device_sign": sign_device,
            "sign_s": sign_s, "t_start": t_start, "t_keys": t_keys,
            "t_queued": time.perf_counter()}


def _rlc_verdicts(q: dict, flags: np.ndarray) -> torch.Tensor:
    """The setup's [B, 2] verdicts from its chunks' batch verdicts: all
    True for a chunk that passed, the exact verify for one that did not
    (queued here, after the fetch)."""
    oks, lo = [], 0
    for flag, m_c, s_c in zip(flags, q["msgs"], q["sigs"]):
        hi = lo + m_c.shape[0]
        if flag:
            oks.append(torch.ones(m_c.shape[:2], dtype=torch.bool, device=q["device"]))
        else:
            oks.append(verify_received(q["pks_v"][lo:hi], m_c, s_c, q["device"]))
        lo = hi
    return torch.cat(oks) if len(oks) > 1 else oks[0]


def drain_signed_tables(queued: dict):
    """The one fetch of a queued setup: the verdicts, and with device
    signing the signature bytes in the same copy ->
    ``(sks, pks, msgs_t, sigs_t, ok, timings)``.

    ``ok`` is bool [B, 2] on the setup's device; ``sigs_t`` is on the
    host.  On the ``"rlc"`` route the fetch brings the chunks' batch
    verdicts; a chunk that failed is verified exactly after it, and its
    verdicts fetched too.  ``timings``: ``keys_s``, ``sign_s`` (host
    signing, or the host time to queue the device signing), ``drain_s``
    (from the last queued dispatch to the verdicts and signatures on the
    host: the card's work not hidden behind the host's), ``total_s``,
    ``chunks``, ``device_sign``, ``verify`` (the route) and
    ``verify_route`` ("device" on the card, "plain" where the plain
    versions ran).
    """
    q = queued
    rlc = q["verify"] == "rlc"
    flat = [t.to(torch.uint8).reshape(-1) for t in q["oks"]]  # rlc: one flag a chunk
    if q["device_sign"]:
        flat += [s.reshape(-1) for s in q["sigs"]]
    fetched = torch.cat(flat).cpu().numpy()  # the one fetch
    n_ok = sum(t.numel() for t in q["oks"])
    sigs = (fetched[n_ok:].reshape(-1, q["msgs"][0].shape[1], 64) if q["device_sign"]
            else np.concatenate(q["sigs"]))
    if rlc:
        ok = _rlc_verdicts(q, fetched[:n_ok].astype(bool))
        if not fetched[:n_ok].all():
            ok.cpu()  # the exact verify of a rejected chunk
    else:
        ok = torch.cat(q["oks"]) if len(q["oks"]) > 1 else q["oks"][0]
    t_end = time.perf_counter()
    timings = {
        "keys_s": q["t_keys"] - q["t_start"],
        "sign_s": q["sign_s"],
        "drain_s": t_end - q["t_queued"],
        "total_s": t_end - q["t_start"],
        "chunks": len(q["oks"]),
        "device_sign": q["device_sign"],
        "verify": q["verify"],
        "verify_route": "device" if q["device"].type == "cuda" else "plain",
    }
    return q["sks"], q["pks"], np.concatenate(q["msgs"]), sigs, ok, timings


def setup_signed_tables(batch: int, seed: int = 0, device=None,
                        sign_device: bool | None = None, verify: str = "exact"):
    """One key-set's setup: keys, 2 signs per commander and the table
    verify, with one fetch at the end -> ``(sks, pks, msgs_t, sigs_t, ok,
    timings)``: :func:`queue_signed_tables`, then
    :func:`drain_signed_tables`.  The form of ``ba_tpu/crypto/signed.py::
    setup_signed_tables_overlapped``; on the card it signs there by
    default, in one chunk, as the reference does on its accelerator.
    ``verify`` is ``"exact"`` or ``"rlc"`` (:func:`queue_signed_tables`).
    """
    return drain_signed_tables(queue_signed_tables(batch, seed, device, sign_device, verify))


SIGN_DEVICE_ROUTES = ("auto", True, False)
WARM_SEED = 987654321  # the throw-away key-set warm_signed_tables signs


def sign_on_device(sign_device="auto", device=None) -> bool:
    """Resolve the sign route (``ba_tpu/crypto/signed.py:654``; its
    ``BA_TPU_SIGN_DEVICE`` variable is the ``sign_device`` argument):
    ``True`` / ``False`` force it, ``"auto"`` signs on the device exactly
    when ``device`` (the card unless given) is a CUDA one, where the
    kernels are live.  A CPU device never turns it on."""
    if sign_device is True or sign_device is False:
        return sign_device
    if sign_device != "auto":
        raise ValueError(f"sign_device must be one of {SIGN_DEVICE_ROUTES}, got {sign_device!r}")
    return resolve_device(device).type == "cuda"


def _sign_chunk(sks, pks, lo, device_sign, dev):
    if device_sign:
        return sign_value_tables_device(sks, pks, base=lo, device=dev)
    return sign_value_tables(sks, pks, base=lo)


def _pad_rows(a, pad: int):
    """``a`` with ``pad`` copies of its first row appended (numpy or a
    tensor, whichever it is)."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])


def setup_signed_tables_overlapped(batch: int, seed: int = 0, chunks: int = 2, *,
                                   sign_device="auto", verify: str = "exact", device=None):
    """Key-set setup in ``chunks`` chunks, chunk c's upload and verify
    queued on ``device`` (the card unless given) while the host signs
    chunk c + 1 (``ba_tpu/crypto/signed.py:678``) ->
    ``(sks, pks, msgs_t, sigs_t, ok, timings)``.

    Every chunk has the same shape: the tail chunk is padded with copies
    of its first row, and its verdicts are cut back.  ``sign_device``
    picks the route (:func:`sign_on_device`): on the device each chunk's
    signing (K5', K5, K4, K8, K6) queues behind the previous chunk's
    verify, and the host only builds messages.  ``verify="exact"``
    verifies every signature (K7, K5, K4, K3); ``"rlc"`` queues one batch
    check a chunk (:func:`rlc_batch_ok`) without fetching it, all the
    chunks' flags come back in the one drain, and a chunk that rejects
    falls back to the exact verify after it.  Nothing waits for the card
    before the drain, whose one copy also brings device signatures home.

    ``msgs_t``, ``sigs_t`` are host arrays, byte-identical with
    :func:`setup_signed_tables`'s for the same ``batch`` and ``seed``;
    ``ok`` is bool ``[batch, 2]`` on the device.  ``timings``: ``keys_s``,
    ``sign_s`` (host signing, or the host time to queue device signing),
    ``drain_s`` (last dispatch to verdicts and signatures on the host),
    ``total_s``, ``chunks``, ``device_sign``.
    """
    _check_route(verify)
    if not 1 <= chunks <= batch:
        raise ValueError(f"chunks={chunks} out of range for batch={batch}")
    dev = resolve_device(device)
    device_sign = sign_on_device(sign_device, dev)
    t_start = time.perf_counter()
    sks, pks = commander_keys(batch, seed)
    t_keys = time.perf_counter() - t_start
    per = -(-batch // chunks)
    sign_s = 0.0
    msgs_parts, sigs_parts, queued = [], [], []
    for lo in range(0, batch, per):
        hi = min(batch, lo + per)
        t0 = time.perf_counter()
        m_c, s_c = _sign_chunk(sks[lo:hi], pks[lo:hi], lo, device_sign, dev)
        sign_s += time.perf_counter() - t0
        msgs_parts.append(m_c)
        sigs_parts.append(s_c)
        pk_c = pks[lo:hi]
        if hi - lo < per:  # one shape for every chunk's dispatches
            pk_c, m_c, s_c = (_pad_rows(a, per - (hi - lo)) for a in (pk_c, m_c, s_c))
        if verify == "rlc":
            queued.append((rlc_batch_ok(pk_c, m_c, s_c, dev), pk_c, m_c, s_c, hi - lo))
        else:
            queued.append((verify_received(pk_c, m_c, s_c, dev)[:hi - lo], None, None, None,
                           hi - lo))
    t_signed = time.perf_counter()
    flat = [q[0].to(torch.uint8).reshape(-1) for q in queued]
    if device_sign:
        flat += [sig.reshape(-1) for sig in sigs_parts]
    fetched = torch.cat(flat).cpu().numpy()  # the one drain
    n_ok = sum(q[0].numel() for q in queued)
    if verify == "rlc":
        oks = []
        for flag, (_, pk_c, m_c, s_c, keep) in zip(fetched[:n_ok].astype(bool), queued):
            oks.append(torch.ones((keep, m_c.shape[1]), dtype=torch.bool, device=dev) if flag
                       else verify_received(pk_c, m_c, s_c, dev)[:keep])
        ok = torch.cat(oks) if len(oks) > 1 else oks[0]
        if not fetched[:n_ok].all():
            ok.cpu()  # the fallback's verdicts, drained too
    else:
        ok = torch.cat([q[0] for q in queued]) if len(queued) > 1 else queued[0][0]
    sigs_t = (fetched[n_ok:].reshape(batch, -1, 64) if device_sign
              else np.concatenate(sigs_parts))
    t_end = time.perf_counter()
    timings = {"keys_s": t_keys, "sign_s": sign_s, "drain_s": t_end - t_signed,
               "total_s": t_end - t_start, "chunks": len(queued), "device_sign": device_sign}
    return sks, pks, np.concatenate(msgs_parts), sigs_t, ok, timings


def warm_signed_tables(batch: int, chunks: int = 4, *, sign_device="auto",
                       verify: str = "exact", device=None) -> None:
    """Run the chunk shape :func:`setup_signed_tables_overlapped` will
    dispatch once, off the clock, on the throw-away key-set
    ``seed=987654321`` (``ba_tpu/crypto/signed.py:792``): the sign route's
    kernels, the ``"rlc"`` route's batch check when asked, and the exact
    verify (its fallback) always, each fetched."""
    _check_route(verify)
    dev = resolve_device(device)
    per = -(-batch // chunks)
    sks, pks = commander_keys(per, seed=WARM_SEED)
    m_c, s_c = _sign_chunk(sks, pks, 0, sign_on_device(sign_device, dev), dev)
    if verify == "rlc":
        rlc_batch_ok(pks, m_c, s_c, dev).cpu()
    verify_received(pks, m_c, s_c, dev).cpu()


def sign_round1(key: torch.Tensor, state: SimState, seed: int = 0,
                corrupt: np.ndarray | None = None, dedup_verify: bool = False):
    """The sign-then-verify preamble of a signed agreement
    (``ba_tpu/crypto/signed.py:836``): the round-1 broadcast under
    ``split(key)[0]``, the commanders' signatures of what each general
    received (host-signed), their exact verify on the state's device
    (:func:`verify_exact`) -> ``(relay_key, received, sig_valid)``.

    ``dedup_verify`` verifies each (instance, value) table signature once
    and selects the [B, n] mask from it (``sig_valid_from_tables``);
    per-copy ``corrupt`` faults need the full verify."""
    from ba_tpu_torch.core import rng
    from ba_tpu_torch.core.om import round1_broadcast

    dev = state.device
    k1, k2 = rng.split(key).unbind(-2)
    received = round1_broadcast(k1, state)
    sks, pks = commander_keys(state.batch, seed)
    if dedup_verify:
        if corrupt is not None:
            raise ValueError("per-copy corruption needs the full verify")
        msgs_t, sigs_t = sign_value_tables(sks, pks)
        sig_valid = sig_valid_from_tables(verify_exact(pks, msgs_t, sigs_t, dev), received)
    else:
        msgs, sigs = sign_received(sks, pks, received.cpu().numpy(), corrupt)
        sig_valid = verify_exact(pks, msgs, sigs, dev)
    return k2, received, sig_valid


def signed_sm_agreement(key: torch.Tensor, state: SimState, m: int, withhold=None,
                        corrupt: np.ndarray | None = None, seed: int = 0,
                        collapsed: bool = False) -> dict:
    """End-to-end signed SM(m) (``ba_tpu/crypto/signed.py:871``): sign,
    verify, m relay rounds gated on the validity mask, the quorum ->
    ``sm_agreement``'s dict plus ``sig_valid``."""
    from ba_tpu_torch.core.sm import sm_agreement

    k2, received, sig_valid = sign_round1(key, state, seed, corrupt)
    out = sm_agreement(k2, state, m, withhold, sig_valid, received, collapsed)
    out["sig_valid"] = sig_valid
    return out


def signed_sm_agreement_sharded(mesh, key: torch.Tensor, state: SimState, m: int,
                                corrupt: np.ndarray | None = None, seed: int = 0,
                                collapsed: bool = True) -> dict:
    """Signed SM(m) across a device mesh (``ba_tpu/crypto/signed.py:896``):
    :func:`sign_round1` (on the card its verify runs K7, K5, K4 and K3),
    then the relay and the quorum node-sharded
    (``parallel/sm_parallel.sm_node_sharded``): instances over "data", each
    cluster's generals over "node".  Returns its dict plus ``sig_valid``."""
    from ba_tpu_torch.parallel.mesh import gather_tree
    from ba_tpu_torch.parallel.sm_parallel import sm_node_sharded

    state = gather_tree(state)
    k2, received, sig_valid = sign_round1(key, state, seed, corrupt)
    out = sm_node_sharded(mesh, k2, state, m, received=received, sig_valid=sig_valid,
                          collapsed=collapsed)
    out["sig_valid"] = sig_valid
    return out
