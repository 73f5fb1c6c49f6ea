"""Execution backends for the interactive cluster (``ba_tpu/runtime/backends.py``).

Two interchangeable engines behind ``Cluster``:

- :class:`TorchBackend` — the port's batched core behind a B = 1 facade.
  It pads the roster to a power-of-two capacity, as the JAX package's
  ``JaxBackend`` does: the coins are drawn at the padded shape, so the
  same roster, seed and capacity give the same bits in both packages.
  Multi-round runs and scenario campaigns go through the pipelined
  engine (``parallel/pipeline.py``), K1 on the card at m = 1.
- :class:`PyBackend` — a sequential-Python oracle with the reference
  semantics (ba.py:159-195, 258-285): plain loops and the stdlib's
  ``random`` for the fault coins.

Both draw faults from seeded RNG (the reference uses ``random.randint``
per RPC call, ba.py:44-49, 268-273, unseeded; here they are
reproducible).

``TorchBackend.run_round`` keeps the reference's spans: a signed round is
a ``signed_round`` span, any other a ``compile`` or ``dispatch`` span
classified on the named axes (instance, protocol, m, capacity), so a
roster that crosses a power of two emits a ``recompile`` record naming
``capacity``; on the card a ``compile`` round also emits its artifact
record (``obs/cuda.py``).
"""

from __future__ import annotations

import itertools
import random

import numpy as np
import torch

from ba_tpu_torch import obs
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT, UNDEFINED
from ba_tpu_torch.parallel.mesh import gather_tree

# Dispatches the pipelined engine keeps in flight (the reference's
# ``BA_TPU_PIPELINE_DEPTH`` default).
PIPELINE_DEPTH = 2
# A backend's tag in its round's compile signature: each backend's first
# round at a capacity classifies as that backend's compile.
_INSTANCE_IDS = itertools.count()


class PyBackend:
    """Sequential oracle: one cluster, plain loops, stdlib RNG only."""

    def run_round(self, generals, leader_idx, order_code, seed):
        coins = random.Random(seed)
        n = len(generals)
        alive = [g.alive for g in generals]
        faulty = [g.faulty for g in generals]

        # Round 1: push. A faulty leader flips a coin per recipient
        # (equivocation, ba.py:268-273); the leader keeps the true order.
        received = []
        for i in range(n):
            if i == leader_idx or not faulty[leader_idx]:
                received.append(order_code)
            else:
                received.append(coins.randint(0, 1))

        # Round 2: pull. Each lieutenant tallies its own received command
        # plus every other alive non-primary general's answer; faulty
        # responders coin-flip per query (ba.py:159-186, 44-49).
        majorities = []
        for i in range(n):
            if i == leader_idx:
                majorities.append(order_code)  # ba.py:284-285 (Q1)
                continue
            if not alive[i]:
                majorities.append(UNDEFINED)
                continue
            n_attack = n_retreat = 0
            for j in range(n):
                if j == leader_idx or not alive[j]:
                    continue
                if j == i:
                    vote = received[i]
                elif faulty[j]:
                    vote = coins.randint(0, 1)
                else:
                    vote = received[j]
                if vote == ATTACK:
                    n_attack += 1
                else:
                    n_retreat += 1
            if n_attack > n_retreat:
                majorities.append(ATTACK)
            elif n_retreat > n_attack:
                majorities.append(RETREAT)
            else:
                majorities.append(UNDEFINED)
        return majorities


class TorchBackend:
    """The port's batched core behind a B = 1 interactive facade.

    ``protocol`` selects the agreement engine: ``"om"`` (oral messages —
    OM(1) at m == 1, the EIG tree otherwise) or ``"sm"`` (signed
    messages, SM(m)).  ``signed=True`` (sm only) runs the Ed25519 path:
    a round signs the commander's uttered values on the host, the card
    verifies them (K7, K5, K4, K3), and the validity mask gates the relay;
    ``run_rounds`` runs the signed pipelined engine behind its sign-ahead
    lane (signed by the process's default pool, verified on the card).

    ``device`` is the card unless given (``resolve_device``: no GPU
    raises).  ``rounds_per_dispatch`` is the pipelined engine's rounds a
    dispatch (the reference's ``BA_TPU_PIPELINE_ROUNDS``); it keeps two
    dispatches in flight (``PIPELINE_DEPTH``).  ``run_rounds`` and
    ``run_scenario`` take a call's ``engine`` (``"torch"``, ``"cuda"``,
    or ``None`` / ``"auto"`` for the default: K1 on the card at m = 1,
    the composed torch engine otherwise).  There is nothing to compile,
    so nothing is cached a capacity: a roster that crosses a power of two
    simply runs at the new capacity, and its first round there is the
    classifier's ``compile`` (a ``recompile`` record names ``capacity``).
    """

    def __init__(
        self,
        device=None,
        m: int = 1,
        protocol: str = "om",
        signed: bool = False,
        rounds_per_dispatch: int = 8,
    ):
        if protocol not in ("om", "sm"):
            raise ValueError(f"unknown protocol {protocol!r}")
        if signed and protocol != "sm":
            raise ValueError("signed=True requires protocol='sm'")
        self.device = resolve_device(device)
        self.m = m
        self.protocol = protocol
        self.signed = signed
        self.rounds_per_dispatch = rounds_per_dispatch
        self._sign_lane = None  # the B = 1 commander's keys and round tables
        self._obs_instance = next(_INSTANCE_IDS)

    @staticmethod
    def _capacity(n: int) -> int:
        cap = 4
        while cap < n:
            cap *= 2
        return cap

    def _make_state(self, generals, leader_idx, order_code) -> SimState:
        cap = self._capacity(len(generals))
        # Staged on the host and moved in one copy a field.
        faulty = np.zeros((1, cap), np.bool_)
        alive = np.zeros((1, cap), np.bool_)
        ids = np.zeros((1, cap), np.int32)
        for i, g in enumerate(generals):
            faulty[0, i] = g.faulty
            alive[0, i] = g.alive
            ids[0, i] = g.id
        dev = self.device
        return SimState(
            order=torch.full((1,), order_code, dtype=COMMAND_DTYPE, device=dev),
            leader=torch.full((1,), leader_idx, dtype=torch.int32, device=dev),
            faulty=torch.from_numpy(faulty).to(dev),
            alive=torch.from_numpy(alive).to(dev),
            ids=torch.from_numpy(ids).to(dev),
        )

    def _lane(self):
        """The B = 1 commander's lane (keys of seed 0, as the engine's
        ``sign_seed``), made once; only its keys and tables are used."""
        if self._sign_lane is None:
            from ba_tpu_torch.parallel.signing import SignAheadLane

            self._sign_lane = SignAheadLane(1, seed=0, pool=0, cache=0, device=self.device)
        return self._sign_lane

    def _run_signed(self, state: SimState, key: torch.Tensor) -> torch.Tensor:
        from ba_tpu_torch.core.om import round1_broadcast
        from ba_tpu_torch.core.sm import sm_round
        from ba_tpu_torch.crypto.signed import sign_received, verify_received

        lane = self._lane()
        sks, pks = lane.sks, lane.pks
        k1, k2 = rng.split(key)
        received = round1_broadcast(k1, state)
        msgs, sigs = sign_received(sks, pks, received.cpu().numpy())
        sig_valid = verify_received(pks, msgs, sigs, device=self.device)
        return sm_round(k2, state, self.m, sig_valid=sig_valid, received=received)

    def run_round(self, generals, leader_idx, order_code, seed):
        """One round -> each roster general's majority code."""
        n = len(generals)
        state = self._make_state(generals, leader_idx, order_code)
        key = rng.key(seed, self.device)
        if self.signed:
            # host signing and a verify between two device steps: not a
            # dispatch, so not classified
            with obs.span("signed_round", n=n, m=self.m):
                maj = self._run_signed(state, key)
            return maj[0, :n].tolist()
        axes = {"instance": self._obs_instance, "protocol": self.protocol, "m": self.m,
                "capacity": self._capacity(n)}
        probe = None
        with obs.compile_or_dispatch_span("torch_backend_step", axes=axes, n=n,
                                          protocol=self.protocol) as phase:
            if phase == "compile" and self.device.type == "cuda":
                # K9 resolves the EIG tree on the card; the other steps are plain torch
                probe = obs.cuda.introspect(
                    "torch_backend_step", axes, (key, state), device=self.device,
                    sources=("majority.cu",) if self.protocol == "om" and self.m > 1 else ())
            maj = self._step(key, state)
        if probe is not None:
            probe.emit((maj,))
        return maj[0, :n].tolist()  # one fetch for the whole row

    def _step(self, key, state):
        if self.protocol == "sm":
            from ba_tpu_torch.core.sm import sm_round

            return sm_round(key, state, self.m)
        if self.m == 1:
            from ba_tpu_torch.core.om import om1_round

            return om1_round(key, state)
        from ba_tpu_torch.core.eig import eig_round

        # max_liars keeps its safe n - 1 default: fault flags change
        # interactively (g-state), so no tighter cap is known here.
        return eig_round(key, state, self.m)

    def run_rounds(self, generals, leader_idx, order_code, seed, rounds, engine=None,
                   host_work=None):
        """``rounds`` agreement rounds through the pipelined sweep engine.

        Returns ``(majorities_last, decision_codes, stats)`` — the last
        round's majorities of each roster general (the REPL's
        per-general block), each round's quorum decision code, and the
        engine's stats with its counters — or None for unsigned SM, which
        has no pipelined path (``Cluster`` then runs the rounds one by
        one).  ``host_work(dispatch)`` runs between dispatches while the
        card works (``pipeline_sweep``'s overlap slot).  A signed backend runs the signed megastep behind the
        sign-ahead lane (``pipeline_sweep(signed=True)``, tables of
        ``sign_seed`` 0); its last round's block is recomputed from the
        same round's tables, verified exactly on the backend's device (K7,
        K5, K4 and K3 on the card).
        """
        from ba_tpu_torch.parallel.pipeline import (
            fresh_copy,
            make_key_schedule,
            pipeline_sweep,
            round_keys,
        )
        from ba_tpu_torch.parallel.sweep import agreement_step

        engine = None if engine == "auto" else engine
        if self.protocol != "om" and not self.signed:
            if engine == "cuda":
                raise ValueError(f"engine={engine!r} unsupported: protocol="
                                 f"{self.protocol!r} unsigned has no pipelined path")
            return None
        n = len(generals)
        key = rng.key(seed, self.device)
        state = self._make_state(generals, leader_idx, order_code)
        # The engine updates its state in place; keep a copy for the
        # last-round majority recompute below.
        state_copy = fresh_copy(state)
        out = pipeline_sweep(
            key,
            state,
            rounds,
            m=self.m,
            depth=PIPELINE_DEPTH,
            rounds_per_dispatch=min(rounds, self.rounds_per_dispatch),
            collect_decisions=True,
            with_counters=True,
            signed=self.signed,
            engine=engine,
            device=self.device,
            host_work=host_work,
        )
        # The last round's per-general block, recomputed from the same key
        # schedule (counter = rounds - 1): bit-exact with what the engine
        # ran, at the cost of one more B = 1 round.
        keys_last = round_keys(make_key_schedule(key, rounds - 1), 1)
        if self.signed:
            from ba_tpu_torch.crypto.signed import verify_exact
            from ba_tpu_torch.parallel.sweep import signed_agreement_step

            lane = self._lane()
            msgs, sigs = lane.round_tables(rounds - 1)
            ok = verify_exact(lane.pks, msgs, sigs, self.device)
            maj = signed_agreement_step(keys_last, state_copy, ok, m=self.m)["majorities"]
        else:
            maj = agreement_step(keys_last, state_copy, m=self.m)["majorities"]
        majorities = maj[0, :n].tolist()
        decisions = [int(v) for v in out["decisions"][:, 0]]
        stats = dict(out["stats"], counters=out["counters"])
        return majorities, decisions, stats

    def run_scenario(
        self,
        generals,
        leader_idx,
        order_code,
        seed,
        spec,
        checkpoint_every=None,
        checkpoint_path=None,
        checkpoint_keep_last=None,
        supervise=False,
        fault_plan=None,
        mesh=None,
        health_every=None,
        engine=None,
    ):
        """A declarative scenario campaign on the B = 1 interactive cluster.

        The spec compiles against the roster's ids at the padded capacity
        (unknown ids raise), sparse, and runs through
        ``pipeline_sweep(scenario=...)``: kills, revivals, fault flips,
        strategies and re-election all on the device.
        ``checkpoint_every`` / ``checkpoint_path`` /
        ``checkpoint_keep_last`` go to the engine's carry checkpoints.
        Oral messages only: returns None for sm / signed.

        ``mesh`` goes to the engine's mesh path (``pipeline_sweep(mesh=)``);
        this facade is B = 1, so the mesh's "data" axis must be 1 (a larger
        one raises the engine's divisibility error).  ``health_every``
        goes to the engine's health sampler.

        ``supervise=True`` runs the campaign under
        ``runtime/supervisor.supervised_sweep`` (watchdogged retires,
        retries in place, recovery from the newest valid checkpoint, OOM
        degradation), with the same dials, and adds its ``supervisor``
        block to ``stats``.  ``fault_plan`` (a ``runtime.chaos.FaultPlan``
        or a live injector) injects faults and needs ``supervise``.  A
        supervised resume whose checkpoints carry no rows history (written
        unsupervised) assembles only the campaign's tail, and raises.

        Returns a dict: ``decisions`` (per-round quorum codes),
        ``leaders`` (per-round roster indices), ``counters``, ``stats``,
        and the final ``alive`` / ``faulty`` rows for the roster update.
        """
        from ba_tpu_torch.parallel.pipeline import pipeline_sweep
        from ba_tpu_torch.scenario.compile import compile_scenario

        if self.protocol != "om" or self.signed:
            return None
        if fault_plan is not None and not supervise:
            raise ValueError("fault_plan requires supervise=True")
        n = len(generals)
        cap = self._capacity(n)
        ids = np.zeros(cap, np.int64)
        for i, g in enumerate(generals):
            ids[i] = g.id
        block = compile_scenario(spec, batch=1, capacity=cap, ids=ids, sparse=True)
        key = rng.key(seed, self.device)
        state = self._make_state(generals, leader_idx, order_code)
        # one dict for both arms, so the supervised campaign keeps every dial
        kwargs = dict(
            m=self.m,
            depth=PIPELINE_DEPTH,
            rounds_per_dispatch=min(spec.rounds, self.rounds_per_dispatch),
            collect_decisions=True,
            scenario=block,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
            checkpoint_keep_last=checkpoint_keep_last,
            mesh=mesh,
            health_every=health_every,
            engine=None if engine == "auto" else engine,
            device=self.device,
        )
        if supervise:
            from ba_tpu_torch.runtime.supervisor import supervised_sweep

            out = supervised_sweep(key, state, spec.rounds, chaos=fault_plan, **kwargs)
            sup = out["supervisor"]
            stats = dict(out["stats"], supervisor=sup)
            if sup["history_start"] != 0:
                # the per-round tally below would cover only the tail
                raise ValueError(
                    f"supervised resume assembled only rounds [{sup['history_start']}, "
                    f"{spec.rounds}) — the prior checkpoints at {checkpoint_path!r} have no "
                    f"rows-history sidecars (written unsupervised?); rerun with a fresh "
                    f"checkpoint_path, or resume unsupervised")
        else:
            out = pipeline_sweep(key, state, spec.rounds, **kwargs)
            stats = out["stats"]
        final = gather_tree(out["final_state"])
        return {
            "decisions": [int(v) for v in out["decisions"][:, 0]],
            "leaders": [int(v) for v in out["leaders"][:, 0]],
            "counters": out["counters"],
            "stats": stats,
            "alive": final.alive[0, :n].tolist(),
            "faulty": final.faulty[0, :n].tolist(),
        }

    def run_search(self, generals, seed, space=None, **kwargs):
        """An adversary hunt sized to this cluster's shape on the backend's
        device (``search/loop.hunt``).  Candidates start from the canonical
        all-honest state, so the roster is read for its padded width only:
        the default space is 8 rounds at that capacity, a population of 32,
        2 to 6 events a candidate.  An explicit ``space`` (a SearchSpace or
        its dict form) replaces it; ``kwargs`` go to ``hunt``
        (generations, objective, export_dir, checkpoint_path, mesh,
        engine, ...).  Oral messages only: returns None for sm / signed."""
        if self.protocol != "om" or self.signed:
            return None
        from ba_tpu_torch.search.generate import SearchSpace
        from ba_tpu_torch.search.loop import hunt

        if space is None:
            space = SearchSpace(rounds=8, capacity=self._capacity(len(generals)),
                                population=32, events_min=2, events_max=6)
        kwargs.setdefault("device", self.device)
        return hunt(space, seed=seed, **kwargs)
