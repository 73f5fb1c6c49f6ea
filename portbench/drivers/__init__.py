"""Campaign drivers, one a program entry that a traffic mix names by its
``driver`` key.  A driver makes the cell's inputs from the seed, queues
and retires campaigns, keeps the outputs the comparison samples, and
gives the reference's view of the same sample.

Its interface, as the harness calls it: ``setup()``; ``start_window()``;
``queue(c)`` -> a handle; ``retire(handle)``; ``stats()``;
``trace_bounds(count)``; ``plan(compared)``; ``program_sample(plan)``;
``prepare(plan)`` (the inputs the reference needs); ``release()``;
``reference_sample(plan, control=False)``;
``self_checks(plan)``; and the attributes ``rounds_per_campaign``,
``warmup_first`` and ``spans`` (host spans by name, seconds).
"""

from __future__ import annotations

import torch

from portbench.inputs import draws


class Base:
    """What every driver shares: the seed's campaign keys, the retained
    campaigns and the host spans."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, engine: str):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.engine = engine
        self.max_campaigns = traffic["max_campaigns"]
        self.warmup_first = self.max_campaigns
        self.spans: dict = {}
        self.kept: dict = {}
        self.n_kept = 0

    def campaign_keys(self) -> None:
        """Campaign c's key, for every campaign a run may queue and the
        warm-up ones after them."""
        self.keys = draws.campaign_keys(self.seed, self.max_campaigns + self.traffic["in_flight"],
                                        self.device)
        self.keys_host = self.keys.cpu()

    def check_index(self, c: int) -> None:
        if c >= self.warmup_first + self.traffic["in_flight"]:
            raise RuntimeError(f"campaign {c} past the traffic's max_campaigns "
                               f"({self.max_campaigns})")

    def keep(self, c: int) -> bool:
        """Whether campaign c's outputs are kept for the comparison: the
        first ``check.campaigns`` of those the seed draws (campaign 0
        always).  Call once a campaign, when it is queued."""
        check = self.traffic["check"]
        if (c >= self.max_campaigns or self.n_kept >= check["campaigns"]
                or not draws.retained(self.seed, c, check["retain_every"])):
            return False
        self.n_kept += 1
        return True

    def start_window(self) -> None:
        self.kept.clear()
        self.n_kept = 0
        for values in self.spans.values():
            values.clear()

    def prepare(self, plan: dict) -> None:
        pass

    def compared(self, campaigns: int) -> list[int]:
        """The kept campaigns of the window, which the comparison reads."""
        return sorted(c for c in self.kept if c < campaigns)
