"""The port's SHA-512 (``ba_tpu_torch/crypto/sha512.py``) and K5's plain
version (``ops/sha512_kernel.py``) against hashlib, Python integers and
``ba_tpu.crypto.sha512``, tolerance zero; and the constants written into
the CUDA sources of K5 and K6 against the values the plain module
computes."""

import hashlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.crypto import sha512 as jsha
from ba_tpu_torch.crypto import oracle, scalar, sha512
from ba_tpu_torch.ops import sha512_kernel

CSRC = pathlib.Path(__file__).resolve().parents[1] / "ba_tpu_torch/ops/csrc"
LENGTHS = [0, 1, 16, 80, 111, 112, 127, 128, 200]


def _msgs(nbytes: int, n: int = 4) -> np.ndarray:
    return np.random.default_rng(nbytes).integers(0, 256, (n, nbytes), dtype=np.uint8)


def test_constants_match_reference():
    assert sha512.K64 == jsha.K64 and sha512.H64 == jsha.H64


@pytest.mark.parametrize("nbytes", LENGTHS)
def test_padding_and_message_words_match_reference(nbytes):
    n_blocks, tail = sha512._pad_layout(nbytes)
    want_blocks, want_tail = jsha._pad_layout(nbytes)
    assert n_blocks == want_blocks and np.array_equal(tail, want_tail)
    msg = _msgs(nbytes)
    wh, wl, nb = sha512._message_words(torch.tensor(msg))
    jwh, jwl, jnb = jsha._message_words(jnp.asarray(msg))
    assert nb == jnb and wh.dtype == torch.int64
    assert np.array_equal(wh.numpy(), np.asarray(jwh)) and np.array_equal(wl.numpy(), np.asarray(jwl))


@pytest.mark.parametrize("nbytes", [0, 16, 80, 112, 200])
def test_sha512_matches_hashlib_and_reference(nbytes):
    msg = _msgs(nbytes)
    got = sha512.sha512(torch.tensor(msg)).numpy()
    for i in range(len(msg)):
        assert got[i].tobytes() == hashlib.sha512(msg[i].tobytes()).digest()
    assert np.array_equal(got, np.asarray(jsha.sha512(jnp.asarray(msg))))


@pytest.mark.parametrize("nbytes", [0, 80, 112, 200])
def test_sha512_mod_l_plain_matches_integers_and_reference(nbytes):
    msg = _msgs(nbytes, 6)
    before = sha512_kernel.sha512_blocks_mod_l.launches
    got = sha512.sha512_mod_l(torch.tensor(msg)).numpy()
    assert sha512_kernel.sha512_blocks_mod_l.launches == before  # the CPU runs the plain version
    for i in range(len(msg)):
        digest = int.from_bytes(hashlib.sha512(msg[i].tobytes()).digest(), "little")
        assert int.from_bytes(got[i].tobytes(), "little") == digest % oracle.L
    assert np.array_equal(got, np.asarray(jsha.sha512_mod_l(jnp.asarray(msg))))


def test_wrapper_rejects_bad_inputs():
    wh, wl, nb = sha512._message_words(torch.tensor(_msgs(80)))
    with pytest.raises(ValueError):
        sha512_kernel.sha512_blocks_mod_l(wh, wl, nb + 1)
    with pytest.raises(ValueError):
        sha512_kernel.sha512_blocks_mod_l(wh.to("meta"), wl.to("meta"), nb)


def _cu_array(name: str, source: str) -> list[int]:
    text = (CSRC / source).read_text()
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    return [int(x.strip().removesuffix("ULL"), 0) for x in body.split(",") if x.strip()]


def test_kernel_source_constants():
    assert _cu_array("SHA512_K", "sha512_modl.cu") == sha512.K64
    assert _cu_array("SHA512_H0", "sha512_modl.cu") == sha512.H64
    # the word-form mod-L core's constants against the oracle's L: delta =
    # L - 2^252 in 4 words and M = 2^260 - floor(2^512 / L) in 5
    L = oracle.L

    def words(v, n):
        assert v < 2 ** (32 * n)
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]

    assert _cu_array("MODL_DELTA", "modl.cuh") == words(L - 2**252, 4)
    assert _cu_array("MODL_M", "modl.cuh") == words(2**260 - 2**512 // L, 5)
    assert list(scalar._L32[:16]) == list(scalar._DELTA)  # the plain fold reads delta from L
