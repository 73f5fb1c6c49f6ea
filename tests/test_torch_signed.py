"""The port's signature tables, native signer and host verify against
``ba_tpu.crypto.signed`` and the pure-Python oracle: keys, messages,
signatures and verdicts byte-identical (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import signed as jsigned
from ba_tpu_torch import convert, native
from ba_tpu_torch.crypto import oracle, signed


@pytest.mark.parametrize("seed", [0, 7])
def test_commander_keys_and_tables_match_reference(seed):
    want_sks, want_pks = jsigned.commander_keys(6, seed)
    sks, pks = signed.commander_keys(6, seed)
    assert sks == want_sks
    assert np.array_equal(pks, np.asarray(want_pks))
    for base in (0, 1000):
        want_m, want_s = jsigned.sign_value_tables(want_sks, want_pks, base=base)
        msgs, sigs = signed.sign_value_tables(sks, pks, base=base)
        assert np.array_equal(msgs, want_m) and np.array_equal(sigs, want_s)


@pytest.mark.parametrize("n_values,base", [(2, 0), (3, 17)])
def test_value_table_msgs(n_values, base):
    msgs = signed._value_table_msgs(5, n_values, base)
    assert np.array_equal(msgs, jsigned._value_table_msgs(5, n_values, base))
    for b in range(5):
        for v in range(n_values):
            assert msgs[b, v].tobytes() == signed.order_message(base + b, v)
            assert signed.order_message(base + b, v) == jsigned.order_message(base + b, v)
    assert signed.MSG_LEN == jsigned.MSG_LEN


def test_verify_host_exact_matches_reference_on_corrupted_tables():
    sks, pks = signed.commander_keys(8, 3)
    msgs, sigs = signed.sign_value_tables(sks, pks)
    sigs = sigs.copy()
    msgs = msgs.copy()
    sigs[0, 0, 0] ^= 0x01   # R
    sigs[1, 1, 31] ^= 0x80  # R's sign bit
    sigs[2, 0, 40] ^= 0x04  # S
    sigs[3, 1, 63] ^= 0xF0  # S past L
    msgs[4, 0, 8] ^= 0x01   # the claimed value
    msgs[5, 1, 4] ^= 0x01   # the bound instance
    got = signed.verify_host_exact(pks, msgs, sigs)
    want = np.asarray(jsigned.verify_host_exact(pks, msgs, sigs))
    assert got.dtype == np.bool_ and got.shape == (8, 2)
    assert np.array_equal(got, want)
    assert not got[:6].all() and got[6:].all()
    assert (~got).sum() == 6


def test_native_signer_matches_oracle():
    sks, pks = signed.commander_keys(3, 11)
    msgs, sigs = signed.sign_value_tables(sks, pks)
    for b in range(3):
        assert oracle.publickey(sks[b]) == pks[b].tobytes()
        for v in range(2):
            msg = msgs[b, v].tobytes()
            assert oracle.sign(sks[b], pks[b].tobytes(), msg) == sigs[b, v].tobytes()
            assert oracle.verify(pks[b].tobytes(), msg, sigs[b, v].tobytes())
    bad = sigs[0, 0].copy()
    bad[33] ^= 1
    assert not oracle.verify(pks[0].tobytes(), msgs[0, 0].tobytes(), bad.tobytes())
    assert not native.verify_batch(pks[:1], msgs[0, :1], bad[None])[0]
    sk_arr = np.stack([np.frombuffer(s, np.uint8) for s in sks])
    with pytest.raises(ValueError):
        native.sign_batch(sk_arr[:2], pks, msgs[:, 0])
    with pytest.raises(ValueError):
        native.verify_batch(pks, msgs[:, 0], sigs[:, 0, :32])


@pytest.mark.parametrize("V", [2, 3])
def test_sig_valid_from_tables(V):
    rs = np.random.default_rng(V)
    ok = rs.random((9, V)) < 0.6
    received = rs.integers(0, V, (9, 13)).astype(np.int8)
    want = np.asarray(jsigned.sig_valid_from_tables(jnp.asarray(ok), jnp.asarray(received)))
    got = signed.sig_valid_from_tables(torch.tensor(ok), torch.tensor(received))
    assert np.array_equal(want, got.numpy())


def test_setup_signed_tables():
    """Two chunks of 3 and 2 commanders: keys, messages and signatures
    byte-identical with the reference's, verdicts equal to its host
    verifier's."""
    sks, pks, msgs, sigs, ok, timings = signed.setup_signed_tables(5, seed=2, device="cpu")
    want_sks, want_pks = jsigned.commander_keys(5, 2)
    want_m, want_s = jsigned.sign_value_tables(want_sks, want_pks)
    assert sks == want_sks and np.array_equal(pks, np.asarray(want_pks))
    assert np.array_equal(msgs, want_m) and np.array_equal(sigs, want_s)
    assert ok.dtype == torch.bool and ok.shape == (5, 2) and bool(ok.all())
    assert np.array_equal(ok.numpy(), jsigned.verify_host_exact(pks, msgs, sigs))
    assert timings["chunks"] == signed.SETUP_CHUNKS == 2
    assert timings["device_sign"] is False and timings["verify_route"] == "plain"
    for name in ("keys_s", "sign_s", "drain_s", "total_s"):
        assert timings[name] >= 0
    assert timings["total_s"] >= timings["sign_s"] + timings["keys_s"]


@pytest.fixture(scope="module")
def corrupted_tables():
    """6 commanders' tables with a corrupted R, S, message or key."""
    sks, pks = signed.commander_keys(6, 5)
    msgs, sigs = signed.sign_value_tables(sks, pks)
    msgs, sigs, pks = msgs.copy(), sigs.copy(), pks.copy()
    sigs[0, 1, 2] ^= 0x40    # R
    sigs[1, 0, 50] ^= 0x01   # S
    msgs[2, 1, 9] ^= 0x01    # the pad of the message
    pks[3] = pks[4]          # another commander's key
    return pks, msgs, sigs


def test_verify_received_matches_host_exact(corrupted_tables):
    pks, msgs, sigs = corrupted_tables
    got = signed.verify_received(pks, msgs, sigs, device="cpu")
    want = jsigned.verify_host_exact(pks, msgs, sigs)
    assert got.dtype == torch.bool and got.shape == (6, 2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), signed.verify_host_exact(pks, msgs, sigs))
    assert (~got).sum() == 5


def test_verify_received_chunks_and_pads(monkeypatch, corrupted_tables):
    """12 signatures in chunks of 5: three dispatches, the last of the 2
    left (no padding); the verdicts are the unchunked ones."""
    pks, msgs, sigs = corrupted_tables
    calls = []
    verify = signed.ed25519.verify

    def counting(pk, msg, sig):
        calls.append(pk.shape[0])
        return verify(pk, msg, sig)

    monkeypatch.setattr(signed, "VERIFY_CHUNK", 5)
    monkeypatch.setattr(signed.ed25519, "verify", counting)
    got = signed.verify_received(pks, msgs, sigs, device="cpu")
    assert calls == [5, 5, 2]
    assert np.array_equal(got.numpy(), signed.verify_host_exact(pks, msgs, sigs))


def test_tables_from_numpy():
    sks, pks = jsigned.commander_keys(4, 0)
    msgs, sigs = jsigned.sign_value_tables(sks, pks)
    ok = jnp.asarray(np.array([[1, 0], [1, 1], [0, 0], [0, 1]], bool))
    t_pks, t_msgs, t_sigs, t_ok = convert.tables_from_numpy(pks, msgs, sigs, ok, "cpu")
    assert t_pks.dtype == np.uint8 and np.array_equal(t_pks, np.asarray(pks))
    assert np.array_equal(t_msgs, msgs) and np.array_equal(t_sigs, sigs)
    assert t_ok.dtype == torch.bool and np.array_equal(t_ok.numpy(), np.asarray(ok))
    t_sigs[0, 0, 0] ^= 1  # owned copies
    assert not np.array_equal(t_sigs, sigs)
