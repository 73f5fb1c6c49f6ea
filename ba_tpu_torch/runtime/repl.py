"""The interactive REPL, byte for byte the JAX package's (``ba_tpu/runtime/repl.py``).

Command surface and exact output formats follow SURVEY.md section 3.1
(reference ba.py:354-445):

- ``actual-order <cmd>`` — run one agreement round, print every general's
  line ``G{id}, {primary|secondary}, majority={m}, state={F|NF}`` then the
  ``Execute order: ...`` quorum line (ba.py:383-399, 237-255).
- ``g-state`` / ``g-state <id> <faulty|non-faulty>`` — show / set fault
  flags (ba.py:401-413); with three tokens the role column is omitted and
  any third token other than "faulty" means non-faulty.
- ``g-kill <id>`` — remove a general (ba.py:415-425).
- ``g-add <n>`` — spawn n more (ba.py:427-437).
- ``List`` — ``P{id}, {True|False}`` primary flags (ba.py:439-445).
- ``Exit`` — leave the loop (ba.py:373-374).

Extensions, as in the JAX package:

- ``run-rounds <cmd> <R>`` — R agreement rounds in one pipelined device
  run: the last round's block in ``actual-order`` format, then a
  ``Rounds: ...`` decision tally; on a signed backend (the signed
  megastep behind the sign-ahead lane) then ``Signed lane:
  sign_ahead_s=<s>, dispatches=<d>``.
- ``scenario <file> [<ckpt-path> <every>] [supervise] [engine=torch|cuda|auto]``
  — a declarative scenario campaign through the pipelined mutating
  engine: the decision tally and the scenario counters, then the roster
  in the campaign's final state; with a checkpoint path, the carry is
  written every <every> rounds; with ``supervise``, the campaign runs
  under the supervisor (``runtime/supervisor.py``) and a ``Scenario
  supervisor: attempts=..., retries=..., recoveries=..., stalls=...``
  line follows, and a supervisor that gives up prints one ``scenario
  error: ...`` line.

``scenario <file> ... mesh=N`` runs the campaign on ``make_mesh((N, 1))``
over the backend's device.  ``serve start [queue=N] [window=S]
[batch=N] [warm=0|1] [engine=torch|cuda|auto]`` / ``serve stat`` /
``serve stop`` run a local agreement service
(``runtime/serve.py``) on the backend's device.  ``stats`` prints the
metrics registry as Prometheus-style text (nothing while it is empty);
``stats --live`` one health sample (``obs/health.py``, rates since the
previous ``stats --live``) and, with an SLO engine installed that has
reported, one ``slo_worst ...`` line.  ``stats --fleet`` prints one
rollup line merged from the sink directory's shards (``obs/fleet.py``);
without a directory sink it prints the one line that differs from the
JAX package's, which names ``ba_tpu_torch.utils.metrics.configure`` in
place of ``BA_TPU_METRICS``.  ``search [gens=N] [objective=NAME]
[export=DIR] [stop=N] [space=FILE]`` runs an adversary hunt sized to the
cluster (``search/``), and ``fleet start|stat|drain|stop`` a local
replicated serving fleet (``fleet/``), both on the backend's device.
Every command runs in a ``repl_command`` span.

Divergences from the reference (guarded crashes there, SURVEY.md section
3.3): unknown ids and an empty cluster are ignored (Q4), and election is
event-driven, so ``actual-order`` right after killing the leader cannot
hit a not-yet-reelected assert (Q5).
"""

from __future__ import annotations

from ba_tpu_torch import obs
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.supervisor import SupervisorError
from ba_tpu_torch.scenario import spec as scenario_spec

# The one line that differs from the JAX package's REPL: the port reads no
# BA_TPU_METRICS, so the sharded sink is configured in code.
FLEET_NO_SINK = ('fleet (no sharded sink — call ba_tpu_torch.utils.metrics.configure("<dir>/"))')
SERVE_USAGE = ("serve error: usage: serve start [queue=N] [window=S] [batch=N] [warm=0|1] "
               "| serve stat | serve stop")
SCENARIO_USAGE = ("(usage: scenario <file> [<ckpt-path> <every>] "
                  "[supervise] [mesh=N] [engine=...])")


def _fmt_state(faulty: bool) -> str:
    return "F" if faulty else "NF"


def quorum_line(res) -> str:
    """The ``Execute order: ...`` line, exactly as ba.py:237-255 builds it."""
    quorum_text = f"{res.needed} out of {res.total} quorum suggests"
    quorum_fail = f"{res.n_undefined} out of {res.total} quorum not consistent"
    faulty_text = "Non-faulty nodes in the system"
    if res.nr_faulty > 0:
        faulty_text = f"{res.nr_faulty} faulty node(s) in the system"
    if res.decision == "retreat":
        decision = f"retreat! {faulty_text} - {quorum_text} retreat"
    elif res.decision == "attack":
        decision = f"attack! {faulty_text} - {quorum_text} attack"
    else:
        decision = (
            "cannot be determined - not enough generals in the system! "
            f"{faulty_text} - {quorum_fail}"
        )
    return f"Execute order: {decision}"


def _print_round(res, out) -> None:
    for gid, is_primary, maj, faulty in res.per_general:
        status = "primary" if is_primary else "secondary"
        out(f"G{gid}, {status}, majority={maj}, state={_fmt_state(faulty)}")
    out(quorum_line(res))


def handle_command(cluster: Cluster, line: str, out) -> bool:
    """Dispatch one REPL line.  Returns False when the loop should stop."""
    cmd = line.split(" ")
    with obs.span("repl_command", command=cmd[0]):
        return _dispatch(cluster, cmd, out)


def _dispatch(cluster: Cluster, cmd: list, out) -> bool:
    command = cmd[0]

    if command == "Exit":
        return False

    elif command == "actual-order":
        if len(cmd) == 1:
            return True
        res = cluster.actual_order(cmd[1])
        if res is None:
            return True
        _print_round(res, out)

    elif command == "run-rounds":
        if len(cmd) < 3:
            return True
        try:
            rounds = int(cmd[2])
        except ValueError:
            return True
        if rounds < 1:
            return True
        ran = cluster.actual_order_rounds(cmd[1], rounds)
        if ran is None:
            return True
        res, counts, stats = ran
        _print_round(res, out)
        out(
            f"Rounds: {rounds} - attack={counts['attack']}, "
            f"retreat={counts['retreat']}, undefined={counts['undefined']}"
        )
        if stats and stats.get("signed"):
            # the sign-ahead lane ran: its overlap wall and the dispatches
            out(f"Signed lane: sign_ahead_s={stats.get('sign_ahead_s')}, "
                f"dispatches={stats.get('dispatches')}")

    elif command == "scenario":
        _scenario(cluster, cmd, out)

    elif command == "serve":
        _serve(cluster, cmd, out)

    elif command == "stats":
        _stats(cmd, out)

    elif command == "search":
        _search(cluster, cmd, out)

    elif command == "fleet":
        _fleet(cluster, cmd, out)

    elif command == "g-state":
        if len(cmd) == 3:
            try:
                gid = int(cmd[1])
            except ValueError:
                return True
            # Any third token other than "faulty" means non-faulty (ba.py:407).
            if not cluster.set_faulty(gid, cmd[2] == "faulty"):
                return True
        for g in cluster.generals:
            primarity = ", primary" if g.id == cluster.leader_id else ", secondary"
            primarity = primarity if len(cmd) != 3 else ""
            out(f"G{g.id}{primarity}, state={_fmt_state(g.faulty)}")

    elif command == "g-kill":
        if len(cmd) == 1:
            return True
        try:
            gid = int(cmd[1])
        except ValueError:
            return True
        cluster.kill(gid)

    elif command == "g-add":
        if len(cmd) == 1:
            return True
        try:
            count = int(cmd[1])
        except ValueError:
            return True
        cluster.add(count)

    elif command == "List":
        for g in cluster.generals:
            out(f"P{g.id}, {g.id == cluster.leader_id}")

    return True


def _scenario(cluster: Cluster, cmd: list, out) -> None:
    """``scenario``: spec problems print one error line; an incapable
    backend (PyBackend, SM) is silently ignored like other guarded
    divergences.  The reference-exact ``line.split(" ")`` keeps empty
    tokens, so a trailing space would read as an empty checkpoint path:
    drop them here."""
    args = [t for t in cmd[1:] if t]
    engine = None
    for tok in list(args):
        if tok.startswith("engine="):
            engine = tok[len("engine="):]
            if not engine:
                out("scenario error: engine= wants one of torch|cuda|auto")
                return
            args.remove(tok)
    mesh_n = None
    for tok in list(args):
        if tok.startswith("mesh="):
            try:
                mesh_n = int(tok[len("mesh="):])
            except ValueError:
                out(f"scenario error: mesh= wants a device count, "
                    f"got {tok[len('mesh='):]!r}")
                return
            if mesh_n < 1:
                out(f"scenario error: mesh= must be >= 1, got {mesh_n}")
                return
            args.remove(tok)
    supervise = False
    if args and args[-1] == "supervise":
        supervise = True
        args = args[:-1]
    if not args:
        return
    ck_path = ck_every = None
    if len(args) == 2:
        # A path without <every> would silently run uncheckpointed.
        out(f"scenario error: checkpoint path given without <every> {SCENARIO_USAGE}")
        return
    if len(args) > 3:
        out(f"scenario error: too many arguments {SCENARIO_USAGE}")
        return
    if len(args) == 3:
        ck_path = args[1]
        try:
            ck_every = int(args[2])
        except ValueError:
            out(f"scenario error: <every> must be an integer, got {args[2]!r}")
            return
        if ck_every < 1:
            out(f"scenario error: <every> must be >= 1, got {ck_every}")
            return
    try:
        spec = scenario_spec.load(args[0])
    except (OSError, ValueError) as e:
        out(f"scenario error: {e}")
        return
    try:
        mesh = None
        device = getattr(cluster.backend, "device", None)
        if mesh_n is not None and device is not None:
            # over the backend's device: on one card (or the CPU) mesh=2
            # cannot build, and its ValueError names both counts
            from ba_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh((mesh_n, 1), ("data", "node"), devices=[device])
        ran = cluster.run_scenario(spec, checkpoint_every=ck_every, checkpoint_path=ck_path,
                                   supervise=supervise, mesh=mesh, engine=engine)
    except (OSError, ValueError, SupervisorError) as e:
        # ValueError: the spec names ids not in the roster, an unknown
        # engine or a mesh the device cannot hold; OSError: an unwritable
        # checkpoint path, mid-campaign; SupervisorError: a supervised
        # campaign ran out of budget or quarantined a window.
        out(f"scenario error: {e}")
        return
    if ran is None:
        return
    counts, res = ran
    out(
        f"Scenario {spec.name}: {spec.rounds} rounds - "
        f"attack={counts['attack']}, retreat={counts['retreat']}, "
        f"undefined={counts['undefined']}"
    )
    out("Scenario counters: " + ", ".join(f"{k}={v}" for k, v in res["counters"].items()))
    if ck_path is not None:
        out(f"Scenario checkpoints: {res['stats'].get('checkpoints', 0)} -> {ck_path}")
    if supervise:
        sup = res["stats"]["supervisor"]
        out(f"Scenario supervisor: attempts={sup['attempts']}, retries={sup['retries']}, "
            f"recoveries={sup['recoveries']}, stalls={sup['stalls']}")


SEARCH_USAGE = "(usage: search [gens=N] [objective=NAME] [export=DIR] [stop=N] [space=FILE])"


def _search(cluster: Cluster, cmd: list, out) -> None:
    """``search [gens=N] [objective=NAME] [export=DIR] [stop=N]
    [space=FILE]``: an adversary hunt sized to this cluster on the
    backend's device (``Cluster.run_search``).  An incapable backend
    (PyBackend, signed or SM) is silently ignored; every configuration
    problem prints one ``search error:`` line."""
    kwargs = {}
    space = None
    for tok in (t for t in cmd[1:] if t):
        key, sep, value = tok.partition("=")
        if not sep or not value or key not in ("gens", "stop", "objective", "export",
                                                "space"):
            out(f"search error: unknown token {tok!r} {SEARCH_USAGE}")
            return
        if key in ("gens", "stop"):
            try:
                n = int(value)
            except ValueError:
                out(f"search error: {key}= wants an integer, got {value!r}")
                return
            if n < 1:
                out(f"search error: {key}= must be >= 1, got {n}")
                return
            kwargs["generations" if key == "gens" else "stop_after"] = n
        elif key == "objective":
            kwargs["objective"] = value
        elif key == "export":
            kwargs["export_dir"] = value
        else:
            import json

            from ba_tpu_torch.search.generate import space_from_dict

            try:
                with open(value) as fh:
                    space = space_from_dict(json.load(fh))
            except (OSError, ValueError) as e:
                out(f"search error: {e}")
                return
    try:
        res = cluster.run_search(space=space, **kwargs)
    except (OSError, ValueError, ImportError) as e:
        out(f"search error: {e}")
        return
    if res is None:
        return
    stats = res["stats"]
    out(f"Search: generations={stats['generations_run']}, campaigns={stats['campaigns']}, "
        f"objective={stats['objective']}")
    shrunk = res["minimized"]
    note = (" ({} minimized, events {})".format(
        len(shrunk), ", ".join(f"{m['events_before']}->{m['events_after']}" for m in shrunk))
        if shrunk else "")
    out(f"Search found: {stats['found']} violating campaign(s), best score "
        f"{stats['best_score']}{note}")
    if res["exported"]:
        out("Search exported: " + ", ".join(res["exported"]))


def _serve(cluster: Cluster, cmd: list, out) -> None:
    """``serve start [queue=N] [window=S] [batch=N] [warm=0|1]
    [engine=torch|cuda|auto]`` / ``serve stat`` / ``serve stop``: a local
    ``AgreementService`` on the backend's device (the card for a backend
    without one), printing the JAX package's lines."""
    from ba_tpu_torch.obs import registry as _registry
    from ba_tpu_torch.runtime import serve as serve_mod

    args = [t for t in cmd[1:] if t]
    if not args or args[0] not in ("start", "stat", "stop"):
        out(SERVE_USAGE)
        return
    svc = getattr(cluster, "_serve_service", None)
    if args[0] == "start":
        if svc is not None and svc.running():
            out("serve error: already running (serve stop first)")
            return
        overrides = {}
        names = {"queue": ("max_queue", int), "window": ("coalesce_window_s", float),
                 "batch": ("max_batch", int), "warm": ("warm", int), "engine": ("engine", str)}
        for tok in args[1:]:
            key, sep, val = tok.partition("=")
            if not sep or key not in names:
                out(f"serve error: unknown option {tok!r} (usage: serve start [queue=N] "
                    f"[window=S] [batch=N] [warm=0|1] [engine=torch|cuda|auto])")
                return
            field, cast = names[key]
            try:
                overrides[field] = cast(val)
            except ValueError:
                out(f"serve error: {key}= wants a {cast.__name__}, got {val!r}")
                return
        if "warm" in overrides:
            overrides["warm"] = bool(overrides["warm"])
        device = getattr(cluster.backend, "device", None)
        try:
            cfg = serve_mod.ServeConfig(device=None if device is None else str(device),
                                        **overrides)
            svc = serve_mod.AgreementService(cfg, registry=_registry.default_registry())
            svc.start()
        except (RuntimeError, ValueError) as e:
            out(f"serve error: {e}")
            return
        cluster._serve_service = svc
        out(f"serve: started (queue={cfg.max_queue}, window={cfg.coalesce_window_s}s, "
            f"batch={cfg.max_batch}" + (", warm" if cfg.warm else "") + ")")
    elif svc is None:
        out("serve error: not running (serve start first)")
    elif args[0] == "stat":
        for k, v in svc.stats().items():
            out(f"serve_{k} {v}")
    else:
        svc.stop()
        cluster._serve_service = None
        st = svc.stats()
        out(f"serve: stopped — admitted={st['admitted']}, completed={st['completed']}, "
            f"rejected={st['rejected']}, expired={st['expired']}, failed={st['failed']}")


FLEET_USAGE = ("fleet error: usage: fleet start [replicas=N] [root=DIR] [hops=N] [vnodes=N] "
               "[queue=N] [window=S] [warm=0|1] | fleet stat | fleet drain <replica> | "
               "fleet stop")


def _fleet(cluster: Cluster, cmd: list, out) -> None:
    """``fleet start [replicas=N] [root=DIR] [hops=N] [vnodes=N] [queue=N]
    [window=S] [batch=N] [warm=0|1]`` / ``fleet stat`` / ``fleet drain
    <replica>`` / ``fleet stop``: a local replicated serving fleet
    (``ba_tpu_torch.fleet``) on the backend's device (the card for a
    backend without one), printing the JAX package's lines."""
    from ba_tpu_torch import fleet as fleet_mod
    from ba_tpu_torch.runtime import serve as serve_mod

    args = [t for t in cmd[1:] if t]
    if not args or args[0] not in ("start", "stat", "drain", "stop"):
        out(FLEET_USAGE)
        return
    mgr = getattr(cluster, "_fleet_manager", None)
    if args[0] == "start":
        if mgr is not None:
            out("fleet error: already running (fleet stop first)")
            return
        fleet_over, serve_over = {}, {}
        names = {"replicas": (fleet_over, "replicas", int), "root": (fleet_over, "root", str),
                 "hops": (fleet_over, "max_hops", int), "vnodes": (fleet_over, "vnodes", int),
                 "queue": (serve_over, "max_queue", int),
                 "window": (serve_over, "coalesce_window_s", float),
                 "batch": (serve_over, "max_batch", int), "warm": (serve_over, "warm", int)}
        for tok in args[1:]:
            key, sep, val = tok.partition("=")
            if not sep or key not in names:
                out(f"fleet error: unknown option {tok!r} (usage: fleet start [replicas=N] "
                    f"[root=DIR] [hops=N] [vnodes=N] [queue=N] [window=S] [batch=N] "
                    f"[warm=0|1])")
                return
            target, field, cast = names[key]
            try:
                target[field] = cast(val)
            except ValueError:
                out(f"fleet error: {key}= wants a {cast.__name__}, got {val!r}")
                return
        if "warm" in serve_over:
            serve_over["warm"] = bool(serve_over["warm"])
        device = getattr(cluster.backend, "device", None)
        try:
            fcfg = fleet_mod.FleetConfig(**fleet_over)
            scfg = serve_mod.ServeConfig(device=None if device is None else str(device),
                                         **serve_over)
        except ValueError as e:
            out(f"fleet error: {e}")
            return
        mgr = fleet_mod.ReplicaManager(fcfg, serve_config=scfg)
        try:
            mgr.start()
        except serve_mod.ServeError as e:
            mgr.stop()
            out(f"fleet error: {e}")
            return
        cluster._fleet_manager = mgr
        cluster._fleet_router = fleet_mod.FleetRouter(mgr)
        out(f"fleet: started {len(mgr.ready())} replica(s) (hops={fcfg.max_hops}, "
            f"vnodes={fcfg.vnodes}" + (f", root={fcfg.root}" if fcfg.root else "")
            + (", warm" if scfg.warm else "") + ")")
    elif mgr is None:
        out("fleet error: not running (fleet start first)")
    elif args[0] == "stat":
        st = cluster._fleet_router.stats()
        out(f"fleet_routes {st['routes']}")
        out(f"fleet_reroutes {st['reroutes']}")
        out(f"fleet_ready {st['ready']}")
        for h in st["replicas"]:
            out(f"fleet_replica {h['replica']} state={h['state']} queue={h['queue_depth']} "
                f"tier={h['tier']} admitted={h['admitted']} rejected={h['rejected']}")
    elif args[0] == "drain":
        if len(args) != 2:
            out("fleet error: usage: fleet drain <replica>")
            return
        try:
            adopted = mgr.drain(args[1])
        except (KeyError, serve_mod.ServeError) as e:
            out(f"fleet error: {e}")
            return
        out(f"fleet: drained {args[1]} — {len(adopted)} campaign(s) migrated, "
            f"{len(mgr.ready())} replica(s) still serving")
    else:
        mgr.stop()
        st = cluster._fleet_router.stats()
        cluster._fleet_manager = None
        cluster._fleet_router = None
        out(f"fleet: stopped — routes={st['routes']}, reroutes={st['reroutes']}")


def run_repl(cluster: Cluster, stdin, out) -> None:
    for line in stdin:
        if not handle_command(cluster, line.rstrip("\n"), out):
            break


def _stats(cmd: list, out) -> None:
    """``stats`` / ``stats --live`` / ``stats --fleet`` (module
    docstring); every line host-side, no wait on the card."""
    if "--live" in cmd[1:]:
        snap = obs.health.default_sampler().sample()
        for k, v in snap.items():
            if v is not None:
                out(f"{k} {'+Inf' if v == float('inf') else v}")
        try:  # the installed engine's last report, read lock-free
            eng = obs.slo.installed()
            worst = eng.last_worst if eng is not None else None
            if worst is not None:
                out(f"slo_worst burn={worst['burn']} cohort={worst['cohort']} "
                    f"tenant={worst['tenant']} p99_s={worst['p99_s']} phase={worst['phase']}")
        except Exception as e:
            out(f"slo_worst error: {e}")
        return
    if "--fleet" in cmd[1:]:
        # merged on demand from the shards on disk: each process appends to
        # its own shard, so reading here takes no writer's lock
        try:
            from ba_tpu_torch.utils import metrics as _metrics

            target = _metrics.default_sink().target
            if not _metrics.is_dir_target(target):
                out(FLEET_NO_SINK)
                return
            from ba_tpu_torch.obs import fleet as _fleet

            out(_fleet.summary_line(_fleet.fleet_summary(_fleet.merge_shards(target))))
        except Exception as e:
            out(f"fleet error: {e}")
        return
    for ln in obs.default_registry().prometheus_text().splitlines():
        out(ln)
