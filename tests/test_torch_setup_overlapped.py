"""The rest of the signing setup (``ba_tpu_torch/crypto/signed.py``:
``sign_on_device``, ``setup_signed_tables_overlapped``,
``warm_signed_tables``) against the JAX package's, on the CPU.

The reference on the CPU signs on the host (its auto mode) and verifies
with the native verifier.  The port's tables are held byte for byte
against it (``sks``, ``pks``, ``msgs``, ``sigs``) and its verdicts
against the reference's, at batch 16 in 1 and 3 chunks (a padded tail
chunk), by both verify routes (the port's ``"rlc"`` route is the
reference's ``BA_TPU_VERIFY_RLC=1``; on self-signed tables both routes
accept every signature), with the ``timings`` keys equal.  On the CPU
the port's verify runs the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from ba_tpu.crypto import signed as j_signed
from ba_tpu_torch.crypto import signed

BATCH = 16


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BA_TPU_SIGN_DEVICE", "0")
        mp.delenv("BA_TPU_VERIFY_RLC", raising=False)
        return {chunks: j_signed.setup_signed_tables_overlapped(BATCH, seed=5, chunks=chunks)
                for chunks in (1, 3)}


@pytest.mark.parametrize("verify", ["exact", "rlc"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_overlapped_setup_equals_reference(reference, chunks, verify):
    sks, pks, msgs, sigs, ok, timings = signed.setup_signed_tables_overlapped(
        BATCH, seed=5, chunks=chunks, sign_device=False, verify=verify, device="cpu")
    j_sks, j_pks, j_msgs, j_sigs, j_ok, j_timings = reference[chunks]
    assert sks == j_sks
    for got, want in ((pks, j_pks), (msgs, j_msgs), (sigs, j_sigs)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))
    assert ok.dtype == torch.bool and ok.device.type == "cpu"
    assert np.array_equal(ok.numpy(), np.asarray(j_ok)) and ok.all()
    assert set(timings) == set(j_timings)
    assert timings["chunks"] == j_timings["chunks"] == chunks
    assert timings["device_sign"] is False and timings["total_s"] >= timings["drain_s"]


def test_device_sign_route_on_the_cpu_matches_host_sign():
    """The device route (``ed25519.sign`` through the plain K5', K5, K4,
    K8, K6 on the CPU) signs the same bytes, in a padded tail chunk too."""
    host = signed.setup_signed_tables(3, seed=2, device="cpu", sign_device=False)
    dev = signed.setup_signed_tables_overlapped(3, seed=2, chunks=2, sign_device=True,
                                                device="cpu")
    assert np.array_equal(host[2], dev[2]) and np.array_equal(host[3], dev[3])
    assert dev[4].all() and dev[5]["device_sign"] is True and dev[5]["chunks"] == 2
    signed.warm_signed_tables(3, chunks=2, sign_device=False, verify="rlc", device="cpu")


def test_rlc_reject_falls_back_to_the_exact_verify(monkeypatch):
    """A chunk whose batch check rejects is verified exactly after the
    drain; its verdicts are the exact verify's (here all True)."""
    flags = iter([True, False])
    monkeypatch.setattr(signed, "rlc_batch_ok",
                        lambda *a: torch.tensor(next(flags), dtype=torch.bool))
    calls = []
    exact = signed.verify_received
    monkeypatch.setattr(signed, "verify_received",
                        lambda *a, **kw: calls.append(1) or exact(*a, **kw))
    _, _, _, _, ok, timings = signed.setup_signed_tables_overlapped(
        4, seed=9, chunks=2, sign_device=False, verify="rlc", device="cpu")
    assert ok.shape == (4, 2) and ok.all() and len(calls) == 1 and timings["chunks"] == 2


def test_sign_on_device_resolution(monkeypatch):
    assert signed.sign_on_device(True, "cpu") is True
    assert signed.sign_on_device(False, "cpu") is False
    assert signed.sign_on_device("auto", "cpu") is False  # a CPU device never turns it on
    assert signed.sign_on_device("auto", torch.device("cuda")) is True
    with pytest.raises(ValueError):
        signed.sign_on_device("1", "cpu")
    with pytest.raises(ValueError):
        signed.setup_signed_tables_overlapped(4, chunks=5, device="cpu")
    with pytest.raises(ValueError):
        signed.setup_signed_tables_overlapped(4, verify="fast", device="cpu")
