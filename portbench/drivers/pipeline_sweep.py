"""Campaigns of ``pipeline_sweep``: plain OM(1) rounds through the
pipelined engine, dispatches queued ``depth`` ahead.

A campaign is one call on a copy of the set-up state (the entry consumes
its state) under campaign c's key, with decisions and counters collected;
it returns with its results on the host.  The comparison recomputes, for
each of a few kept campaigns, whole rounds in the reference (every
instance's decision, the histogram and the round's counter increments)
and sampled instances in every round, each campaign its own sample; it
checks every round's histogram and the counters the decisions fix against
the program's own decisions, and that every instance with a loyal
commander decides the order in every round (interactive consistency IC2,
which the reference's semantics give).
"""

from __future__ import annotations

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState
from ba_tpu_torch.parallel import pipeline
from portbench.drivers import Base
from portbench.inputs import draws, sweep_state
from portbench.reference import om1
from portbench.work import k1

ATTACK, UNDEFINED = 1, 2


def state_of(cfg: dict, device) -> dict:
    return sweep_state.sweep_state(
        draws.instances_key(cfg, device), cfg["batch"], cfg["capacity"], min_n=cfg["min_n"],
        max_n=cfg["max_n"], max_traitor_frac=cfg["max_traitor_frac"])


def sample_instances(state: dict, k: int, mattering: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    """``k`` instances: half among ``mattering`` (a [B] bool mask of the
    instances whose draws decide something), the rest spread over the
    batch."""
    pick = sweep_state.pick(torch.nonzero(mattering.cpu())[:, 0], k // 2, gen)
    spread = sweep_state.spread_rows(state["faulty"].shape[0], k - len(pick), gen)
    return torch.unique(torch.cat([pick, spread]))


def loyal_commander_mismatch(decisions: np.ndarray, state: dict) -> int:
    """Decisions ``[R, B]`` other than ATTACK (the order) of instances
    whose commander is loyal."""
    loyal = ~state["faulty"][:, 0].cpu().numpy()
    return int((decisions[:, loyal] != ATTACK).sum())


def chunks(rounds: int, per: int) -> list[int]:
    return [per] * (rounds // per) + ([rounds % per] if rounds % per else [])


class Driver(Base):
    def setup(self) -> None:
        self.state = state_of(self.config, self.device)
        self.campaign_keys()
        self.rounds = self.traffic["rounds"]
        self.rounds_per_campaign = self.rounds * self.config["batch"]
        self.counts = {"dispatches": 0, "max_in_flight": 0, "stalls": 0}

    def start_window(self) -> None:
        super().start_window()
        self.counts = dict.fromkeys(self.counts, 0)

    def queue(self, c: int):
        self.check_index(c)
        t = self.traffic
        state = SimState(**{name: x.clone() for name, x in self.state.items()})
        out = pipeline.pipeline_sweep(
            self.keys[c], state, self.rounds, depth=t["depth"],
            rounds_per_dispatch=t["rounds_per_dispatch"], collect_decisions=True,
            with_counters=True, engine=self.engine, device=self.device,
            run_id=f"portbench-{c}")
        s = out["stats"]
        self.counts["dispatches"] += s["dispatches"]
        self.counts["max_in_flight"] = max(self.counts["max_in_flight"], s["max_in_flight"])
        self.counts["stalls"] += s["stalls"]
        if self.keep(c):
            self.kept[c] = {"decisions": out["decisions"], "histograms": out["histograms"],
                            "rows": out["counters_per_round"]}

    def retire(self, handle) -> None:
        pass  # the call returned with its results on the host

    def stats(self) -> dict:
        return dict(self.counts)

    def trace_bounds(self, count: int) -> dict:
        total, by, launches = 0.0, "operations", 0
        for nr in chunks(self.rounds, self.traffic["rounds_per_dispatch"]):
            b_s, by = k1.bound_s(self.state, nr)  # the state and the work repeat each dispatch
            total += b_s * count
            launches += count
        return {"k1_plain": (total, by, launches)}

    def plan(self, compared: list[int]) -> dict:
        """Per compared campaign, its whole rounds and its instances (half
        with a traitorous commander), drawn afresh from the seed."""
        gen = draws.sample_generator(self.seed)
        check = self.traffic["check"]
        traitorous = self.state["faulty"][:, 0]
        return {c: {"rounds": sorted(int(r) for r in
                                     torch.randperm(self.rounds, generator=gen)[:check["rounds"]]),
                    "instances": sample_instances(self.state, check["instances"], traitorous,
                                                  gen)}
                for c in compared}

    @staticmethod
    def _deltas(rows: np.ndarray) -> np.ndarray:
        return np.diff(rows.astype(np.int64), axis=0, prepend=np.zeros_like(rows[:1]))

    def program_sample(self, plan: dict) -> dict:
        got = {"decision": {}, "counter": {}, "instance": {}}
        for c, p in plan.items():
            kept, rounds = self.kept[c], p["rounds"]
            deltas = self._deltas(kept["rows"])
            got["decision"][c] = torch.from_numpy(kept["decisions"][rounds].astype(np.int64))
            got["counter"][c] = torch.from_numpy(np.concatenate(
                [kept["histograms"][rounds], deltas[rounds]], axis=1).astype(np.int64))
            got["instance"][c] = torch.from_numpy(
                kept["decisions"][:, p["instances"].numpy()].astype(np.int64))
        return got

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_sample(self, plan: dict, control: bool = False) -> dict:
        needed = om1.needed_simple_majority if control else om1.needed_3f1
        want = {"decision": {}, "counter": {}, "instance": {}}
        for c, p in plan.items():
            key = self.keys_host[c].to(self.device)
            outs = [om1.plain_round(key, r, self.state, needed) for r in p["rounds"]]
            want["decision"][c] = torch.stack([o["decision"] for o in outs]).long().cpu()
            want["counter"][c] = torch.stack(
                [torch.cat([o["histogram"], o["deltas"]]) for o in outs]).long().cpu()
            idx = p["instances"].to(self.device)
            want["instance"][c] = om1.campaign_decisions(
                key, self.rounds, sweep_state.rows(self.state, idx), idx, needed).long().cpu()
        return want

    def self_checks(self, plan: dict) -> dict:
        """Every round of the compared campaigns: the histogram against the
        decisions, quorum failures against the UNDEFINED decisions,
        unanimity against the histogram; and the loyal commanders'
        instances against the order."""
        B = self.config["batch"]
        per, loyal = {}, {}
        for c in plan:
            kept = self.kept[c]
            dec = kept["decisions"].astype(np.int64)
            hist = np.stack([(dec == code).sum(axis=1) for code in range(3)], axis=1)
            deltas = self._deltas(kept["rows"])
            bad = (hist != kept["histograms"]).sum()
            bad += (deltas[:, 0] != (dec == UNDEFINED).sum(axis=1)).sum()
            bad += (deltas[:, 1] != (hist.max(axis=1) == B)).sum()
            per[c] = int(bad)
            loyal[c] = loyal_commander_mismatch(dec, self.state)
        return {"self_mismatch": per, "loyal_commander_mismatch": loyal}
