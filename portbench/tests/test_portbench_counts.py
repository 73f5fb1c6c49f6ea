"""The frozen work and byte counts against counts made by hand."""

from __future__ import annotations

import torch

from portbench.work import k1, k2, peaks


def _state():
    # instance 0: 4 alive, leader 0 honest, general 1 a traitor;
    # instance 1: 3 alive, leader 0 a traitor
    return {
        "order": torch.ones(2, dtype=torch.int8),
        "leader": torch.zeros(2, dtype=torch.int32),
        "faulty": torch.tensor([[False, True, False, False], [True, False, False, False]]),
        "alive": torch.tensor([[True, True, True, True], [True, True, True, False]]),
        "ids": torch.arange(1, 5, dtype=torch.int32).expand(2, 4).clone(),
    }


def test_k1_plain_counts():
    # instance 0: askers {1,2,3}, one coin-drawing responder: 1 * 2 coins ->
    # 1 word + 4 key words; 2 + 3 tally steps.  Instance 1: the leader's 2
    # round-1 coins -> 1 word + 4; 0 + 2 steps.
    assert k1.work_counts(_state(), 1) == (10, 7)
    assert k1.work_counts(_state(), 3) == (30, 21)
    assert k1.dispatch_bytes(2, 4, 1, scenario=False) == 10 + 48 + 32 + 26


def test_k1_kills_and_election():
    kills = torch.zeros((1, 2, 4), dtype=torch.bool)
    kills[0, 0, 0] = True  # instance 0 loses its leader; general 1 (a traitor) leads
    # instance 0: askers {2, 3}, no counted traitor, the new leader's 2 coins
    assert k1.work_counts(_state(), 1, kills) == (5 + 5, 2 + 2)
    b = k1.dispatch_bytes(2, 4, 1, scenario=True)
    assert b == 2 * 5 + 2 * 4 * 7 + 1 * 2 * 4 * 4 + 16 + 4 + 20 + 2 * 4 + 2 * 4 * 3 + 2 * 5 + 32


def test_k2_counts():
    st = _state()
    assert k2.philox_calls(st, 5) == 2 * 5  # instance 1's two recipients a round
    ops, nbytes = k2.dispatch_counts(st, 5, 3)
    assert ops == 2 * 5 * (10 * 3 + 8) + 10 * 80
    assert nbytes == 4 + 2 * 7 + 2 * 2 * 4 + 2 * 5


def test_peaks_and_bound():
    assert peaks.INT_OPS_PER_S == 132 * 64 * 1.98e9
    s, by = peaks.bound_s(peaks.INT_OPS_PER_S, 1.0)
    assert s == 1.0 and by == "operations"
    s, by = peaks.bound_s(0, peaks.HBM_BYTES_PER_S * 2)
    assert s == 2.0 and by == "bytes"
