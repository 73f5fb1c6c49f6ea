"""Replicated serving (the port's copy of ``ba_tpu/fleet/replica.py``): N
in-process ``AgreementService`` replicas under one manager, each with its
own metrics registry, its own dispatcher thread and its own campaign
lanes.

One process, many replicas: a replica is a service plus a name, a state
machine and a campaign ledger, so the fleet tier runs without
multi-process scaffolding while keeping the seams a multi-host
deployment needs:

- **State machine** (``replica_state`` records): ``new -> booting ->
  ready`` on the happy path, ``ready -> draining -> stopped`` on a
  serve-drain (``migrate.drain``), ``-> dead`` on a kill.  The router
  routes only to ``ready`` replicas, and a replica enters the ring after
  its warm barrier and ``warmup.ok()``, so no replica compiles on the
  request path after boot.
- **Campaign lanes**: a long campaign runs on its own thread through
  ``runtime/supervisor.supervised_sweep`` on the replica's device (K1's
  plain or scenario mode on the card), with a ``{round}``-templated
  checkpoint family under the fleet root: shared paths, so any replica
  (of either package) resumes a family bit-exactly through
  ``resume="auto"`` and the rows-sidecar chain.
- **Crash-consistent ledger**: every lane appends fsync'd JSON lines
  (``admit`` -> ``checkpoint``* -> ``done`` | ``handoff``) to its
  replica's ledger under the fleet root.  A killed replica leaves
  admitted, unfinished rows behind; ``migrate.adopt_orphans`` scans
  exactly those and checks each family against its ledgered
  ``campaign_sha256`` before adopting it.
- **Health without locks**: a replica's health reads its own gauge
  objects (``serve_queue_depth`` / ``serve_shed_tier``), never
  ``stats()``, which takes the service's queue condition.
- **Overlapped boot**: ``ReplicaManager.start`` boots the replicas on a
  thread each.  Nothing is shared on disk (``ServeConfig(aot_cache=)``
  raises): each replica captures its own CUDA graphs, and the kernel
  libraries load once a process.

A replica's mutable state (``_state``, ``_campaigns``) is written only
under ``_lock``; the drain and kill flags are ``threading.Event``s.

The reference's ``BA_TPU_FLEET_REPLICAS`` / ``_HOPS`` / ``_VNODES`` /
``_ROOT`` are ``FleetConfig(replicas=, max_hops=, vnodes=, root=)``;
nothing here reads the environment.  Importing this module loads no
torch: the engine is reached only inside a campaign lane
(``Replica._campaign_lane``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

from ba_tpu_torch import obs
from ba_tpu_torch.fleet import migrate
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.runtime import serve as serve_mod
from ba_tpu_torch.utils import metrics as _metrics
from ba_tpu_torch.utils import snapshot as _snapshot

REPLICA_STATES = (
    "new", "booting", "ready", "draining", "stopped", "dead"
)


@dataclasses.dataclass(frozen=True, kw_only=True)
class FleetConfig:
    """The fleet tier's dials: initial replica count, the router's
    reroute bound and virtual-node fan-out, and the shared fleet root
    (campaign checkpoint families + replica ledgers).  ``root=None``
    is a serving-only fleet: requests route, campaigns refuse."""

    replicas: int = 2
    max_hops: int = 3
    vnodes: int = 64
    root: str | None = None
    max_replicas: int = 8

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.max_hops < 1:
            raise ValueError(f"max_hops={self.max_hops} must be >= 1")
        if self.vnodes < 1:
            raise ValueError(f"vnodes={self.vnodes} must be >= 1")
        if self.max_replicas < self.replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} < replicas="
                f"{self.replicas}"
            )


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A seed-reconstructible campaign: everything a replica needs to
    (re)build the exact same supervised sweep — on ANY replica, after
    any number of migrations — lives in this doc.  The identity the
    supervisor fingerprints (key bytes, rounds, scenario content) is a
    pure function of these fields, which is what makes handoff/adopt
    verification possible at all."""

    campaign: str
    seed: int
    state_seed: int
    batch: int
    rounds: int
    capacity: int = 4
    rounds_per_dispatch: int = 1
    checkpoint_every: int = 4
    scenario: dict | None = None

    def __post_init__(self):
        if not self.campaign or not isinstance(self.campaign, str):
            raise ValueError("campaign id must be a non-empty string")
        if any(c in self.campaign for c in (os.sep, "..", "\x00")):
            raise ValueError(
                f"campaign id {self.campaign!r} must be a plain name "
                f"(it becomes a directory under the fleet root)"
            )
        for f in ("batch", "rounds", "capacity", "rounds_per_dispatch",
                  "checkpoint_every"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f}={getattr(self, f)} must be >= 1")

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        if doc["scenario"] is None:
            del doc["scenario"]
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "CampaignSpec":
        if not isinstance(doc, dict):
            raise ValueError(f"campaign doc must be a dict, got {doc!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - known)
        if unknown:
            raise ValueError(f"campaign doc has unknown keys {unknown}")
        return cls(**doc)


class CampaignHandle:
    """The replica's handle on one campaign lane: terminal ``outcome``
    in ``{"completed", "handoff", "abandoned", "error"}`` plus the
    matching payload (result dict / handoff path / error)."""

    def __init__(self, spec: CampaignSpec, directory: str, template: str):
        self.spec = spec
        self.directory = directory
        self.template = template
        self.outcome: str | None = None
        self.result: dict | None = None
        self.error: BaseException | None = None
        self.handoff_path: str | None = None
        self.fingerprint: str | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


def ledger_path(root: str, replica: str) -> str:
    return os.path.join(root, "replicas", replica, "ledger.jsonl")


def read_ledger(root: str, replica: str) -> list:
    """Fold a replica's ledger into per-campaign status entries:
    ``{"campaign", "doc", "template", "fingerprint", "status"}`` with
    ``status`` one of ``done`` / ``handoff`` / ``orphaned`` (admitted,
    never finished — the adoption set after a kill)."""
    path = ledger_path(root, replica)
    entries: dict = {}
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue  # torn final line from a killed writer
        cid = row.get("campaign")
        ev = row.get("ev")
        if not cid or not ev:
            continue
        if ev == "admit":
            entries[cid] = {
                "campaign": cid,
                "doc": row.get("doc"),
                "template": row.get("template"),
                "fingerprint": None,
                "status": "orphaned",
            }
        elif cid in entries:
            if ev == "checkpoint":
                entries[cid]["fingerprint"] = row.get("fingerprint")
            elif ev == "done":
                entries[cid]["status"] = "done"
            elif ev == "handoff":
                entries[cid]["status"] = "handoff"
    return list(entries.values())


class Replica:
    """One named serving replica: an ``AgreementService`` on its own
    registry, a state machine, and campaign lanes (class docstring of
    the module for the architecture)."""

    def __init__(
        self,
        name: str,
        config: FleetConfig | None = None,
        serve_config=None,
        fault_plan=None,
        run_id: str | None = None,
    ):
        self.name = name
        self.config = config or FleetConfig()
        self.registry = MetricsRegistry()
        self.serve_config = serve_config or serve_mod.ServeConfig()
        self.service = serve_mod.AgreementService(
            self.serve_config, fault_plan=fault_plan,
            registry=self.registry,
        )
        self.run_id = run_id
        self._lock = threading.Lock()
        self._state = "new"
        self._campaigns: dict[str, CampaignHandle] = {}
        self._drain_ev = threading.Event()
        self._killed = threading.Event()
        self._ledger_lock = threading.Lock()

    # -- state machine -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def set_state(self, state: str) -> None:
        assert state in REPLICA_STATES, state
        with self._lock:
            prev, self._state = self._state, state
        rec = {
            "event": "replica_state",
            "v": _metrics.SCHEMA_VERSION,
            "replica": self.name,
            "state": state,
            "prev": prev,
        }
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        _metrics.emit(rec)

    def ready(self) -> bool:
        return self.state == "ready"

    # -- lifecycle -----------------------------------------------------------

    def start(self, warm_timeout_s: float | None = None) -> "Replica":
        """Boot: start the service and, with warmup configured, hold at
        the warm barrier until every planned signature was attempted
        with zero errors (``WarmupRunner.ok``) before going ``ready``:
        ring entry waits for the warmup, so no replica builds or
        captures on the request path after boot."""
        self.set_state("booting")
        self.service.start()
        if not self.service.warm_barrier(warm_timeout_s):
            raise serve_mod.ServeError(
                f"replica {self.name}: warm barrier not reached within "
                f"{warm_timeout_s}s"
            )
        warmup = self.service._warmup
        if warmup is not None and not warmup.ok():
            raise serve_mod.ServeError(
                f"replica {self.name}: warmup finished with "
                f"{warmup.errors} error(s) — refusing ring entry cold"
            )
        self.set_state("ready")
        return self

    def stop(self, timeout: float | None = None) -> None:
        self._drain_ev.set()
        for handle in self.campaigns():
            handle.wait(timeout)
        self.service.stop(drain=True, timeout=timeout)
        self.set_state("stopped")

    def kill(self) -> None:
        """The in-process stand-in for SIGKILL: serving stops without
        drain (queued tickets fail: the router's reroute signal), and
        campaign lanes are abandoned at their next checkpoint hook: no
        handoff header, no ledger ``done`` row, only the periodic
        checkpoints (each written atomically) and the fsync'd ledger,
        the residue a real SIGKILL leaves for ``migrate.adopt_orphans``.
        A dispatch in flight on the card runs to its end."""
        self._killed.set()
        self._drain_ev.set()
        self.set_state("dead")
        self.service.stop(drain=False)

    # -- serving -------------------------------------------------------------

    def submit(self, request, deadline_s=...):
        return self.service.submit(request, deadline_s=deadline_s)

    def health(self) -> dict:
        """Lock-free health view: plain attribute reads off this
        replica's own gauge/counter objects (never ``stats()``, which
        takes the service's queue condition)."""
        reg = self.registry
        depth = reg.gauge("serve_queue_depth").value
        limit = self.serve_config.max_queue
        return {
            "replica": self.name,
            "state": self.state,
            "queue_depth": depth,
            "queue_frac": depth / limit if limit else 0.0,
            "tier": reg.gauge("serve_shed_tier").value,
            "admitted": reg.counter("serve_admitted_total").value,
            "rejected": reg.counter("serve_rejected_total").value,
        }

    # -- campaign lanes ------------------------------------------------------

    def campaigns(self) -> list:
        with self._lock:
            return list(self._campaigns.values())

    def campaign(self, cid: str) -> CampaignHandle | None:
        with self._lock:
            return self._campaigns.get(cid)

    def _ledger(self, row: dict) -> None:
        path = ledger_path(self.config.root, self.name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        line = json.dumps(row, sort_keys=True) + "\n"
        with self._ledger_lock:
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def run_campaign(self, spec: CampaignSpec) -> CampaignHandle:
        """Start (or adopt — same call: ``resume="auto"`` makes them
        one operation) a campaign lane.  Requires a fleet root: the
        checkpoint family and the ledger are the migration substrate."""
        if self.config.root is None:
            raise ValueError(
                "campaigns need a fleet root (FleetConfig(root=)) — "
                "serving-only fleets cannot migrate what they cannot "
                "checkpoint"
            )
        if not self.ready():
            raise serve_mod.ServeError(
                f"replica {self.name} is {self.state}, not ready"
            )
        directory = os.path.join(
            self.config.root, "campaigns", spec.campaign
        )
        os.makedirs(directory, exist_ok=True)
        template = os.path.join(directory, "ck_{round}.npz")
        handle = CampaignHandle(spec, directory, template)
        with self._lock:
            if spec.campaign in self._campaigns and not (
                self._campaigns[spec.campaign].done()
            ):
                raise ValueError(
                    f"campaign {spec.campaign!r} already running on "
                    f"{self.name}"
                )
            self._campaigns[spec.campaign] = handle
        thread = threading.Thread(
            target=self._campaign_main,
            args=(handle,),
            name=f"ba-fleet-{self.name}-{spec.campaign}",
            daemon=True,
        )
        thread.start()
        return handle

    def stop_lanes(self) -> None:
        """Tell every lane to stop at its next checkpoint (no wait)."""
        self._drain_ev.set()

    def drain_campaigns(self, timeout_s: float | None = None) -> list:
        """Stop every lane at its next checkpoint, wait for them, and
        collect the handoff header paths (``migrate.drain`` calls this
        after the serve-side handoff).  Zero lanes → the empty list, no
        files."""
        self.stop_lanes()
        paths = []
        for handle in self.campaigns():
            handle.wait(timeout_s)
            if handle.outcome == "handoff":
                paths.append(handle.handoff_path)
        return paths

    def _campaign_main(self, handle: CampaignHandle) -> None:
        spec = handle.spec
        try:
            self._ledger({
                "ev": "admit",
                "campaign": spec.campaign,
                "doc": spec.to_doc(),
                "template": handle.template,
            })
            result = self._campaign_lane(handle)
        except migrate.DrainStop as stop:
            if self._killed.is_set():
                # SIGKILL simulation: die mid-lane, write NOTHING more.
                handle.outcome = "abandoned"
            else:
                self._write_handoff(handle, stop)
        except Exception as e:
            handle.error = e
            handle.outcome = "error"
            obs.instant(
                "fleet_campaign_error", replica=self.name,
                campaign=spec.campaign, error=type(e).__name__,
            )
        else:
            handle.result = result
            handle.outcome = "completed"
            self._ledger({"ev": "done", "campaign": spec.campaign})
        finally:
            handle._event.set()

    def _campaign_lane(self, handle: CampaignHandle) -> dict:
        # The only frame of the fleet tier that reaches the engine: rebuild
        # the campaign from its doc and run it supervised on the replica's
        # device, checkpointing into the shared family.  The hook fires
        # after the carry and its rows sidecar are durable: the safe point
        # to stop at.
        spec = handle.spec
        from ba_tpu_torch.core import rng
        from ba_tpu_torch.core.state import resolve_device
        from ba_tpu_torch.parallel.sweep import make_sweep_state
        from ba_tpu_torch.runtime.supervisor import SupervisorConfig, supervised_sweep

        dev = resolve_device(self.serve_config.device)
        key = rng.key(spec.seed, dev)
        state = make_sweep_state(rng.key(spec.state_seed, dev), spec.batch, spec.capacity)
        scenario = None
        rounds = spec.rounds
        if spec.scenario is not None:
            from ba_tpu_torch.scenario.compile import compile_scenario
            from ba_tpu_torch.scenario.spec import from_dict

            scenario = compile_scenario(from_dict(dict(spec.scenario)), spec.batch,
                                        spec.capacity, sparse=True)
            rounds = None

        def hook(round_cursor, path):
            if handle.fingerprint is None:
                try:
                    handle.fingerprint = _snapshot.validate_carry_checkpoint(
                        path).get("campaign_sha256")
                except (OSError, ValueError):
                    pass
            self._ledger({
                "ev": "checkpoint",
                "campaign": spec.campaign,
                "round": int(round_cursor),
                "path": path,
                "fingerprint": handle.fingerprint,
            })
            if self._drain_ev.is_set() or self._killed.is_set():
                raise migrate.DrainStop(int(round_cursor), path)

        return supervised_sweep(
            key,
            state,
            rounds,
            scenario=scenario,
            rounds_per_dispatch=spec.rounds_per_dispatch,
            collect_decisions=True,
            checkpoint_every=spec.checkpoint_every,
            checkpoint_path=handle.template,
            on_checkpoint=hook,
            config=SupervisorConfig(timeout_s=60.0),
            device=dev,
        )

    def _write_handoff(self, handle: CampaignHandle,
                       stop: migrate.DrainStop) -> None:
        spec = handle.spec
        try:
            meta = _snapshot.validate_carry_checkpoint(stop.path)
        except (OSError, ValueError):
            meta = {}
        path = os.path.join(handle.directory, "handoff.json")
        migrate.write_handoff(
            path,
            campaign=spec.campaign,
            doc=spec.to_doc(),
            template=handle.template,
            round_cursor=stop.round_cursor,
            rounds=spec.rounds,
            checkpoint=stop.path,
            fingerprint=meta.get("campaign_sha256"),
            signed=bool(meta.get("signed")),
            from_replica=self.name,
            run_id=meta.get("run_id"),
            traceparent=meta.get("traceparent"),
        )
        self._ledger({
            "ev": "handoff", "campaign": spec.campaign, "path": path,
        })
        migrate._emit_migration(
            "handoff", spec.campaign, self.name,
            round=stop.round_cursor, path=path,
            run_id=meta.get("run_id"),
        )
        handle.handoff_path = path
        handle.outcome = "handoff"


class ReplicaManager:
    """Owns the replica roster: boot (thread-per-replica, overlapped
    warmups), name allocation, lookup, drain-to-survivor, kill, stop.
    The router reads ``ready()`` for ring membership."""

    def __init__(
        self,
        config: FleetConfig | None = None,
        serve_config=None,
        fault_plans: dict | None = None,
    ):
        self.config = config or FleetConfig()
        self.serve_config = serve_config
        self._fault_plans = dict(fault_plans or {})
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._counter = 0
        self.run_id = obs.flight.derive_run_id(
            "fleet", self.config.replicas, self.config.vnodes,
            self.config.root or "",
        )

    def _new_replica(self) -> Replica:
        with self._lock:
            name = f"replica-{self._counter}"
            self._counter += 1
        rep = Replica(
            name,
            config=self.config,
            serve_config=self.serve_config,
            fault_plan=self._fault_plans.get(name),
            run_id=self.run_id,
        )
        with self._lock:
            self._replicas[name] = rep
        return rep

    def start(self, n: int | None = None,
              warm_timeout_s: float | None = None) -> list:
        """Boot ``n`` (default: the configured count) replicas with
        overlapped warm barriers, a thread each (each replica captures
        its own graphs; the kernel libraries load once a process)."""
        n = self.config.replicas if n is None else n
        reps = [self._new_replica() for _ in range(n)]
        errors: list = []

        def boot(rep):
            try:
                rep.start(warm_timeout_s)
            except Exception as e:
                errors.append((rep.name, e))

        threads = [
            threading.Thread(
                target=boot, args=(r,), name=f"ba-fleet-boot-{r.name}",
                daemon=True,
            )
            for r in reps
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            name, err = errors[0]
            raise serve_mod.ServeError(
                f"replica {name} failed to boot: {err}"
            ) from err
        return reps

    def start_replica(self,
                      warm_timeout_s: float | None = None) -> Replica:
        return self._new_replica().start(warm_timeout_s)

    def get(self, name: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(name)

    def all(self) -> list:
        with self._lock:
            return list(self._replicas.values())

    def ready(self) -> list:
        return [r for r in self.all() if r.ready()]

    def drain(self, name: str, target: str | None = None,
              timeout_s: float | None = None) -> list:
        """Serve-drain ``name`` and resume each handed-off campaign on
        ``target`` (default: the first OTHER ready replica).  Returns
        the adopted campaign handles ([] for a zero-campaign drain —
        the strict no-op edge)."""
        rep = self.get(name)
        if rep is None:
            raise KeyError(f"no replica {name!r}")
        paths = migrate.drain(rep, timeout_s=timeout_s)
        if not paths:
            return []
        if target is not None:
            dst = self.get(target)
        else:
            dst = next(
                (r for r in self.ready() if r.name != name), None
            )
        if dst is None:
            raise serve_mod.ServeError(
                f"drained {name} with {len(paths)} in-flight "
                f"campaign(s) but no ready replica can adopt them"
            )
        return [migrate.resume_handoff(p, dst) for p in paths]

    def kill(self, name: str) -> None:
        rep = self.get(name)
        if rep is None:
            raise KeyError(f"no replica {name!r}")
        rep.kill()

    def adopt_orphans(self, dead: str, target: str | None = None) -> list:
        """Recover a killed replica's campaigns onto ``target`` (the
        fingerprint-verified path — ``migrate.adopt_orphans``)."""
        if self.config.root is None:
            return []
        if target is not None:
            dst = self.get(target)
        else:
            dst = next((r for r in self.ready() if r.name != dead), None)
        if dst is None:
            raise serve_mod.ServeError(
                f"no ready replica to adopt {dead}'s orphans"
            )
        return migrate.adopt_orphans(self.config.root, dead, dst)

    def stop(self, timeout: float | None = None) -> None:
        for rep in self.all():
            if rep.state in ("stopped", "dead"):
                continue
            rep.stop(timeout)
