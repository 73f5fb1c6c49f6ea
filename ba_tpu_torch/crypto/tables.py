"""The host tier of the signature tables: commander keys, the message
tables, and batch signing and verifying through the native signer
(``ba_tpu_torch.native``).

numpy and the stdlib only, never torch: the signing pool's worker
processes (``crypto/pool.py``) import this module and nothing of the
device tier, so a worker starts in a fraction of a second.
``crypto/signed.py`` re-exports every name here.

Two message grammars, MSG_LEN bytes each, with distinct magics so that
neither verifies as the other:

- a value claim, ``b"BAv1" || instance u32 LE || value u8 || zero pad``
  (``order_message``): "commander of instance b says v";
- a round-bound claim, ``b"BAr1" || instance u32 LE || round u32 LE ||
  value u8 || zero pad`` (``round_message``): "... says v in round r",
  the tables the sign-ahead lane signs for each round of a signed
  campaign (``parallel/signing.py``); binding the round closes the
  replay of one round's signature in another.

Keys, messages and signatures are byte-identical with
``ba_tpu/crypto/signed.py``'s.
"""

from __future__ import annotations

import numpy as np

from ba_tpu_torch import native
from ba_tpu_torch.crypto import oracle

MSG_LEN = 16
_MAGIC = b"BAv1"
_MAGIC_ROUND = b"BAr1"


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


def round_message(instance: int, round_index: int, value: int) -> bytes:
    """The round-bound claim: "commander of ``instance`` says ``value``
    in round ``round_index``"."""
    body = (_MAGIC_ROUND + int(instance).to_bytes(4, "little")
            + int(round_index).to_bytes(4, "little") + bytes([value & 0xFF]))
    return body.ljust(MSG_LEN, b"\0")


def _round_table_msgs(B: int, round_index: int, n_values: int, base: int) -> np.ndarray:
    """``round_message`` over the [B, V] grid -> uint8 [B, V, MSG_LEN];
    row b binds instance ``base + b``."""
    msgs = np.zeros((B, n_values, MSG_LEN), np.uint8)
    msgs[:, :, 0:4] = np.frombuffer(_MAGIC_ROUND, np.uint8)
    msgs[:, :, 4:8] = (
        np.arange(base, base + B, dtype="<u4").view(np.uint8).reshape(B, 1, 4)
    )
    msgs[:, :, 8:12] = np.frombuffer(np.uint32(round_index).tobytes(), np.uint8)
    msgs[:, :, 12] = np.arange(n_values, dtype=np.uint8)[None, :]
    return msgs


def key_table_arrays(sks: list[bytes], pks: np.ndarray,
                     n_values: int) -> tuple[np.ndarray, np.ndarray]:
    """The key rows of a [B, V] signature table: sk and pk uint8 [B * V,
    32], each key once a value column.  Fixed for a key-set, so a caller
    signing many tables under it (the sign-ahead lane) builds them once."""
    return (np.repeat(secret_rows(sks), n_values, axis=0),
            np.repeat(np.asarray(pks, np.uint8), n_values, axis=0))


def sign_table_msgs_arrays(sk_rep: np.ndarray, pk_rep: np.ndarray,
                           msgs: np.ndarray) -> np.ndarray:
    """Sign a [N, V, MSG_LEN] message table with its key rows
    (``key_table_arrays``, tiled over a window of rounds where N spans
    several) -> sigs uint8 [N, V, 64], in one native batch call."""
    N, n_values = msgs.shape[:2]
    return native.sign_batch(
        sk_rep, pk_rep, msgs.reshape(N * n_values, MSG_LEN)
    ).reshape(N, n_values, 64)


def _sign_table_msgs(sks: list[bytes], pks: np.ndarray, msgs: np.ndarray) -> np.ndarray:
    """Sign a [B, V, MSG_LEN] table under the key-set -> sigs uint8
    [B, V, 64]: the one signing body of both table grammars."""
    return sign_table_msgs_arrays(*key_table_arrays(sks, pks, msgs.shape[1]), msgs)


def sign_value_tables(sks: list[bytes], pks: np.ndarray, n_values: int = 2,
                      base: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``n_values`` signs per commander: msgs uint8 [B, V, MSG_LEN] and
    sigs uint8 [B, V, 64].  ``base`` offsets the bound instance ids."""
    msgs = _value_table_msgs(len(sks), n_values, base)
    return msgs, _sign_table_msgs(sks, pks, msgs)


def sign_round_tables(sks: list[bytes], pks: np.ndarray, round_index: int,
                      n_values: int = 2, base: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """One round's tables: msgs uint8 [B, V, MSG_LEN] binding (instance,
    round, value) and their signatures uint8 [B, V, 64]."""
    msgs = _round_table_msgs(len(sks), round_index, n_values, base)
    return msgs, _sign_table_msgs(sks, pks, msgs)


def verify_host_exact(pks, msgs, sigs) -> np.ndarray:
    """Exact per-signature verification on the host -> bool [B, n] numpy:
    pks [B, 32], msgs [B, n, MSG_LEN], sigs [B, n, 64], the cofactorless
    RFC 8032 equation with h reduced mod L, in one native batch call."""
    pks_np = np.asarray(pks, np.uint8)
    msgs_np = np.asarray(msgs, np.uint8)
    sigs_np = np.asarray(sigs, np.uint8)
    B, n = msgs_np.shape[:2]
    return native.verify_batch(
        np.repeat(pks_np, n, axis=0), msgs_np.reshape(B * n, -1), sigs_np.reshape(B * n, 64)
    ).reshape(B, n)
