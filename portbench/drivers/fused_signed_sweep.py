"""Campaigns of the fused signed sweep: signed SM(m) through K2,
``fused_signed_sweep_step``, one dispatch a size bucket a step.

Set-up draws the bucketed states on the device and runs the key-set's
set-up once (``setup_signed_tables_overlapped``: commander keys, the
signed value tables and their exact verify).  A traitorous commander
sends one value, drawn from the seed, under a spoiled signature: byte 0
of it flipped, and the program's exact verify (``verify_received``) run
on those instances' tables again.  The verdicts gate every step: the
spoiled value counts for no one.  A campaign derives its steps' seeds on
the device, runs its steps, counts the decisions that are not ATTACK on
the device and fetches the counts once, at its end; with two in flight
campaign c + 1 is queued before campaign c's counts are fetched.  A kept
campaign also keeps the decisions of one step, drawn from the seed.

The comparison replays, for each kept campaign, its own sample of rows in
the reference (every round): rows spread over each bucket, its edges and
its largest cluster, and rows whose commander is a traitor.  It signs and
verifies a sample of the key-set's instances in the reference, checks the
kept step's count against its decisions, and checks that every instance
with a loyal commander decides the order in every round (IC2).
"""

from __future__ import annotations

import numpy as np
import torch

from ba_tpu_torch.crypto import signed
from ba_tpu_torch.ops import sweep_step
from portbench.drivers import Base
from portbench.drivers.pipeline_sweep import loyal_commander_mismatch
from portbench.inputs import draws, sweep_state
from portbench.reference import ed25519, sm3
from portbench.work import k2

ATTACK = 1
TABLE = -1  # the key the set-up's tables are compared under


class Driver(Base):
    def setup(self) -> None:
        cfg, t = self.config, self.traffic
        self.states = sweep_state.bucketed_states(
            draws.instances_key(cfg, self.device), cfg["batch"], cfg["capacity"], cfg["buckets"],
            min_n=cfg["min_n"], max_traitor_frac=cfg["max_traitor_frac"])
        self.sizes = [st["faulty"].shape[0] for st in self.states]
        self.traitorous = torch.cat([st["faulty"][:, 0] for st in self.states]).cpu().numpy()
        self.bases = list(np.cumsum([0] + self.sizes[:-1]))
        self.keyset_seed = draws.stream_int(self.seed, draws.KEYSET)
        ks = cfg["keyset"]
        _, pks, msgs, sigs, ok, timings = signed.setup_signed_tables_overlapped(
            cfg["batch"], seed=self.keyset_seed, chunks=ks["chunks"],
            sign_device=ks["sign_device"], verify=ks["verify"], device=self.device)
        ok, sigs = self.spoil(pks, msgs, sigs, ok)
        self.tables = {"pks": pks, "msgs": msgs, "sigs": sigs, "ok": ok.cpu().numpy()}
        self.keyset_timings = timings
        self.args = [(st["order"], st["leader"], st["faulty"], st["alive"], ok_b)
                     for st, ok_b in zip(self.states, torch.split(ok, self.sizes))]
        self.campaign_keys()
        self.seed_mix = draws.step_seed_mix(self.seed, self.device)
        self.steps, self.rounds, self.m = t["steps"], t["rounds"], cfg["m"]
        self.rounds_per_campaign = self.steps * self.rounds * cfg["batch"]
        pin = self.device.type == "cuda"
        self.slots = [torch.empty(self.steps, dtype=torch.int64, pin_memory=pin)
                      for _ in range(t["in_flight"])]
        # a kept step's decisions go to host memory, so what a run keeps
        # takes nothing of the card's
        self.kept_decisions = [[torch.empty((size, self.rounds), dtype=torch.int8,
                                            pin_memory=pin) for size in self.sizes]
                               for _ in range(t["check"]["campaigns"])]
        sweep_step.reset_launches()

    def spoiled(self) -> tuple[np.ndarray, np.ndarray]:
        """(instances whose commander is a traitor, the value each spoils)."""
        rows = np.nonzero(self.traitorous)[0]
        values = [draws.spoiled_value(self.seed, int(g)) for g in rows]
        return rows, np.array(values, dtype=np.int64)

    def spoil(self, pks, msgs, sigs, ok):
        rows, values = self.spoiled()
        sigs = sigs.copy()
        sigs[rows, values, 0] ^= 0xFF
        ok = ok.clone()
        ok[torch.from_numpy(rows).to(ok.device)] = signed.verify_received(
            pks[rows], msgs[rows], sigs[rows], self.device)
        return ok, sigs

    def start_window(self) -> None:
        super().start_window()
        sweep_step.reset_launches()

    def kept_step(self, c: int) -> int:
        return draws.stream_int(self.seed, draws.SAMPLES, 2**31 + c) % self.steps

    def queue(self, c: int):
        self.check_index(c)
        nb = len(self.args)
        seeds = draws.step_seeds(self.seed_mix, self.keys[c], self.steps, nb)
        counts = torch.zeros(self.steps, dtype=torch.int64, device=self.device)
        slot = self.n_kept
        decisions = self.kept_decisions[slot] if self.keep(c) else None
        s_keep = self.kept_step(c) if decisions is not None else -1
        for s in range(self.steps):
            decs = [sweep_step.fused_signed_sweep_step(seeds[s, i:i + 1], *args, self.m,
                                                       self.rounds)
                    for i, args in enumerate(self.args)]
            for dec in decs:
                counts[s].add_((dec != ATTACK).sum())
            if s == s_keep:
                for buf, dec in zip(decisions, decs):
                    buf.copy_(dec, non_blocking=True)
        slot = self.slots[c % len(self.slots)]
        slot.copy_(counts, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return c, slot, done, s_keep, decisions

    def retire(self, handle) -> None:
        c, slot, done, s_keep, decisions = handle
        if done is not None:
            done.synchronize()
        if decisions is not None:
            self.kept[c] = {"counts": slot.numpy().copy(), "decisions": decisions}

    def stats(self) -> dict:
        return {"k2_launches": sweep_step.fused_signed_sweep_step.launches,
                "keyset": {k: self.keyset_timings[k]
                           for k in ("keys_s", "sign_s", "drain_s", "total_s", "chunks")}}

    def trace_bounds(self, count: int) -> dict:
        bounds = [k2.bound_s(st, self.rounds, self.m) for st in self.states]
        by = max(bounds)[1]
        total = count * self.steps * sum(b for b, _ in bounds)
        return {"k2": (total, by, count * self.steps * len(self.states))}

    def _sample(self, k_spread: int, k_traitorous: int, gen, *, edges: bool) -> list:
        """Per bucket, rows spread over it and rows whose commander is a
        traitor; with ``edges`` also its first and last rows and its
        largest cluster."""
        rows = []
        for st, base, size in zip(self.states, self.bases, self.sizes):
            traitorous = torch.from_numpy(np.nonzero(self.traitorous[base:base + size])[0])
            parts = [sweep_state.spread_rows(size, k_spread, gen),
                     sweep_state.pick(traitorous, k_traitorous, gen)]
            if edges:
                parts.append(torch.tensor([0, size - 1, int(st["alive"].sum(1).argmax())]))
            rows.append(torch.unique(torch.cat(parts)))
        return rows

    def plan(self, compared: list[int]) -> dict:
        """Per compared campaign, its kept step and its own rows a bucket;
        and the key-set instances whose tables are signed again."""
        gen = draws.sample_generator(self.seed)
        check = self.traffic["check"]
        k_rows, k_tables = check["rows"], check["table_rows"]
        return {"steps": {c: self.kept_step(c) for c in compared},
                "rows": {c: self._sample(k_rows // 2, k_rows - k_rows // 2, gen, edges=True)
                         for c in compared},
                "tables": self._instances(self._sample(k_tables // 2, k_tables - k_tables // 2,
                                                       gen, edges=False))}

    def _instances(self, rows: list) -> list[int]:
        return [int(base) + int(r) for base, part in zip(self.bases, rows) for r in part]

    def program_sample(self, plan: dict) -> dict:
        got = {"decision": {}, "table": {}}
        for c in plan["steps"]:
            decs = self.kept[c]["decisions"]
            got["decision"][c] = torch.cat(
                [dec[rows.to(dec.device)].cpu() for dec, rows in zip(decs, plan["rows"][c])]).long()
        g = plan["tables"]
        t = self.tables
        got["table"][TABLE] = torch.from_numpy(np.concatenate(
            [t["pks"][g], t["sigs"][g].reshape(len(g), -1), t["msgs"][g].reshape(len(g), -1),
             t["ok"][g]], axis=1).astype(np.int64))
        return got

    def release(self) -> None:
        for kept in self.kept.values():
            if "decisions" in kept:
                kept["decisions"] = [d.cpu() for d in kept["decisions"]]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_tables(self, instances: list[int]) -> np.ndarray:
        """The reference's table rows of ``instances``: public key,
        signatures, messages, verdicts."""
        out = []
        for g in instances:
            sk = ed25519.secret_key(self.keyset_seed, g)
            pk = ed25519.publickey(sk)
            msgs = [ed25519.order_message(g, v) for v in (0, 1)]
            sigs = [ed25519.sign(sk, pk, msg) for msg in msgs]
            if self.traitorous[g]:
                v = draws.spoiled_value(self.seed, g)
                sigs[v] = bytes([sigs[v][0] ^ 0xFF]) + sigs[v][1:]
            ok = [ed25519.verify(pk, msg, sig) for msg, sig in zip(msgs, sigs)]
            out.append(np.frombuffer(pk + b"".join(sigs) + b"".join(msgs), np.uint8).tolist()
                       + ok)
        return np.array(out, dtype=np.int64)

    def verdicts(self) -> np.ndarray:
        """[B, 2] whether each instance's signature on each value verifies,
        as the configuration states it: all but the spoiled ones."""
        ok = np.ones((self.config["batch"], 2), dtype=bool)
        rows, values = self.spoiled()
        ok[rows, values] = False
        return ok

    def reference_sample(self, plan: dict, control: bool = False) -> dict:
        """The control counts every value, its signature verified or not."""
        table = self.reference_tables(plan["tables"])
        ok_all = np.ones((self.config["batch"], 2), dtype=bool) if control else self.verdicts()
        want = {"decision": {}, "table": {TABLE: torch.from_numpy(table)}}
        nb = len(self.states)
        for c, s in plan["steps"].items():
            key = tuple(int(x) for x in self.keys_host[c])
            parts = []
            for i, (st, base, rows) in enumerate(zip(self.states, self.bases, plan["rows"][c])):
                ok = torch.from_numpy(ok_all[base:base + self.sizes[i]]).to(self.device)
                seed = draws.step_seed_py(self.seed, key, s, i, nb)
                parts.append(sm3.decisions(seed, st, ok, rows.to(self.device),
                                           self.m, self.rounds).cpu())
            want["decision"][c] = torch.cat(parts).long()
        return want

    def self_checks(self, plan: dict) -> dict:
        per, loyal = {}, {}
        for c, s in plan["steps"].items():
            kept = self.kept[c]
            counted = sum(int((d != ATTACK).sum()) for d in kept["decisions"])
            per[c] = int(kept["counts"][s] != counted)
            loyal[c] = sum(loyal_commander_mismatch(d.numpy().T, st)
                           for d, st in zip(kept["decisions"], self.states))
        return {"count_mismatch": per, "loyal_commander_mismatch": loyal}
