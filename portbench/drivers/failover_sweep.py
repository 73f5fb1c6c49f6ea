"""Campaigns of ``failover_sweep``: crash faults with leader re-election,
one K1 scenario-mode launch of R rounds a campaign.

Set-up draws the state and a pool of kill planes on the device; campaign
c runs plane c mod pool under campaign c's key.  The call returns with
its outputs on the device; their copy to pinned host memory is queued
behind it and waited for at the retire, so with two in flight campaign
c + 1 is queued before campaign c's leaders, decisions and histograms
are fetched.  The comparison replays sampled instances of a few kept
campaigns in the reference (leaders and decisions of every round) and
checks every round's histogram against the program's decisions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.parallel import sweep
from portbench.drivers import Base
from portbench.drivers.pipeline_sweep import sample_instances, state_of
from portbench.inputs import draws, sweep_state
from portbench.reference import om1
from portbench.work import k1

OUTPUTS = ("leaders", "decisions", "histograms")


class Driver(Base):
    def setup(self) -> None:
        cfg, t = self.config, self.traffic
        self.state = state_of(cfg, self.device)
        self.campaign_keys()
        self.rounds = t["rounds"]
        B, n = cfg["batch"], cfg["capacity"]
        self.planes = draws.kill_planes(self.seed, t["kill_planes"], self.rounds, B, n,
                                        t["p_kill"], t["leader_dies_before_round"], self.device)
        self.rounds_per_campaign = self.rounds * B
        pin = self.device.type == "cuda"
        self.slots = [{name: torch.empty(shape, dtype=dtype, pin_memory=pin)
                       for name, shape, dtype in (("leaders", (self.rounds, B), torch.int32),
                                                  ("decisions", (self.rounds, B), torch.int8),
                                                  ("histograms", (self.rounds, 3), torch.int32))}
                      for _ in range(t["in_flight"])]
        self.program_state = SimState(**self.state)  # the entry copies it; it stays as it was
        self.spans = {"failover_sweep": []}

    def queue(self, c: int):
        self.check_index(c)
        t0 = time.perf_counter()
        out = sweep.failover_sweep(self.keys[c], self.program_state,
                                   self.planes[c % len(self.planes)], engine=self.engine,
                                   device=self.device)
        self.spans["failover_sweep"].append(time.perf_counter() - t0)
        slot = self.slots[c % len(self.slots)]
        for name in OUTPUTS:
            slot[name].copy_(out[name], non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return c, slot, done, out

    def retire(self, handle) -> None:
        c, slot, done, _ = handle
        if done is not None:
            done.synchronize()
        if self.keep(c):
            self.kept[c] = {name: slot[name].numpy().copy() for name in OUTPUTS}

    def stats(self) -> dict:
        return {"kill_planes": len(self.planes)}

    def trace_bounds(self, count: int) -> dict:
        total, by = 0.0, "operations"
        per_plane = {}
        for c in range(count):
            p = c % len(self.planes)
            if p not in per_plane:
                per_plane[p] = k1.bound_s(self.state, self.rounds, self.planes[p])
            b_s, by = per_plane[p]
            total += b_s
        return {"k1_scenario": (total, by, count)}

    def plan(self, compared: list[int]) -> dict:
        """Per compared campaign, its sampled instances, drawn afresh: half
        among those whose commander or its successor (the leader after
        the commander's death) is a traitor, the rest spread over the
        batch."""
        gen = draws.sample_generator(self.seed)
        k = self.traffic["check"]["instances"]
        mattering = self.state["faulty"][:, :2].any(dim=1)
        return {c: sample_instances(self.state, k, mattering, gen) for c in compared}

    def program_sample(self, plan: dict) -> dict:
        got = {"leaders": {}, "decisions": {}}
        for c, idx in plan.items():
            for name in got:
                got[name][c] = torch.from_numpy(self.kept[c][name][:, idx.numpy()].astype(np.int64))
        return got

    def prepare(self, plan: dict) -> None:
        """Take the sampled instances' rows of the kill planes."""
        self.kill_rows = {c: self.planes[c % len(self.planes)][:, idx.to(self.device)]
                          for c, idx in plan.items()}

    def release(self) -> None:
        """Frees the kill planes (the sampled rows were taken)."""
        self.planes = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_sample(self, plan: dict, control: bool = False) -> dict:
        want = {"leaders": {}, "decisions": {}}
        for c, idx in plan.items():
            idx_d = idx.to(self.device)
            out = om1.failover_campaign(self.keys_host[c].to(self.device),
                                        sweep_state.rows(self.state, idx_d), idx_d,
                                        self.kill_rows[c], reelect=not control)
            for name in want:
                want[name][c] = out[name].long().cpu()
        return want

    def self_checks(self, plan: dict) -> dict:
        per = {}
        for c in plan:
            dec = self.kept[c]["decisions"].astype(np.int64)
            hist = np.stack([(dec == code).sum(axis=1) for code in range(3)], axis=1)
            per[c] = int((hist != self.kept[c]["histograms"]).sum())
        return {"self_mismatch": per}
