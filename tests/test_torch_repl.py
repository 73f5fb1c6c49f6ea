"""The port's REPL prints the strings ``tests/test_repl.py`` pins, byte for
byte, through ``handle_command`` on the port's ``PyBackend`` and on its
``TorchBackend`` on the CPU, and through the launcher
``python -m ba_tpu_torch.runtime.main``; ``serve``, ``scenario ...
supervise``, ``search``, ``fleet`` and ``stats --fleet`` print the JAX
package's lines (``stats --fleet`` without a directory sink prints the one
line that differs)."""

import pathlib
import subprocess
import sys

import pytest
import torch

from ba_tpu_torch import obs
from ba_tpu_torch.obs.registry import MetricsRegistry
from ba_tpu_torch.runtime.backends import PyBackend, TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.main import build_cluster
from ba_tpu_torch.runtime.repl import handle_command

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = {"py": PyBackend, "torch": lambda: TorchBackend(device="cpu")}


def drive(cluster, lines):
    out = []
    for line in lines:
        if not handle_command(cluster, line, out.append):
            break
    return out


@pytest.fixture(params=sorted(BACKENDS))
def make_backend(request):
    return BACKENDS[request.param]


@pytest.fixture()
def cluster4(make_backend):
    return Cluster(4, make_backend(), seed=0)


def test_g_state_initial(cluster4):
    assert drive(cluster4, ["g-state"]) == [
        "G1, primary, state=NF",
        "G2, secondary, state=NF",
        "G3, secondary, state=NF",
        "G4, secondary, state=NF",
    ]


def test_actual_order_all_honest(cluster4):
    assert drive(cluster4, ["actual-order attack"]) == [
        "G1, primary, majority=attack, state=NF",
        "G2, secondary, majority=attack, state=NF",
        "G3, secondary, majority=attack, state=NF",
        "G4, secondary, majority=attack, state=NF",
        "Execute order: attack! Non-faulty nodes in the system"
        " - 3 out of 4 quorum suggests attack",
    ]


def test_g_state_set_faulty_drops_role_column(cluster4):
    assert drive(cluster4, ["g-state 2 faulty"]) == [
        "G1, state=NF",
        "G2, state=F",
        "G3, state=NF",
        "G4, state=NF",
    ]


def test_actual_order_one_faulty_lieutenant(cluster4):
    out = drive(cluster4, ["g-state 2 faulty", "actual-order retreat"])
    assert out[4:] == [
        "G1, primary, majority=retreat, state=NF",
        "G2, secondary, majority=retreat, state=F",
        "G3, secondary, majority=retreat, state=NF",
        "G4, secondary, majority=retreat, state=NF",
        "Execute order: retreat! 1 faulty node(s) in the system"
        " - 3 out of 4 quorum suggests retreat",
    ]


def test_kill_add_list_and_reelection(cluster4):
    out = drive(cluster4, ["g-kill 1", "List", "g-add 2", "List", "actual-order attack"])
    assert out == [
        "P2, True",
        "P3, False",
        "P4, False",
        "P2, True",
        "P3, False",
        "P4, False",
        "P5, False",
        "P6, False",
        "G2, primary, majority=attack, state=NF",
        "G3, secondary, majority=attack, state=NF",
        "G4, secondary, majority=attack, state=NF",
        "G5, secondary, majority=attack, state=NF",
        "G6, secondary, majority=attack, state=NF",
        "Execute order: attack! Non-faulty nodes in the system"
        " - 3 out of 5 quorum suggests attack",
    ]


def test_raw_command_string_passthrough(cluster4):
    assert drive(cluster4, ["actual-order foo"]) == [
        "G1, primary, majority=foo, state=NF",
        "G2, secondary, majority=retreat, state=NF",
        "G3, secondary, majority=retreat, state=NF",
        "G4, secondary, majority=retreat, state=NF",
        "Execute order: retreat! Non-faulty nodes in the system"
        " - 3 out of 4 quorum suggests retreat",
    ]


def test_single_general_undefined_quorum(make_backend):
    cluster = Cluster(1, make_backend(), seed=0)
    assert drive(cluster, ["actual-order foo"]) == [
        "G1, primary, majority=foo, state=NF",
        "Execute order: cannot be determined - not enough generals in the"
        " system! Non-faulty nodes in the system - 1 out of 1 quorum not"
        " consistent",
    ]


def test_guarded_edges_do_not_crash(cluster4):
    out = drive(
        cluster4,
        ["g-kill", "g-kill 99", "g-state 99 faulty", "g-add", "nonsense", "",
         "actual-order", "g-kill 1", "g-kill 2", "g-kill 3", "g-kill 4", "List",
         "actual-order attack", "run-rounds attack 3", "g-state"],
    )
    assert out == []


def test_exit_stops_loop(cluster4):
    assert drive(cluster4, ["Exit", "g-state"]) == []


def test_faulty_leader_election_not_disturbed(cluster4):
    drive(cluster4, ["g-state 1 faulty"])
    assert cluster4.leader_id == 1
    drive(cluster4, ["g-kill 1"])
    assert cluster4.leader_id == 2


@pytest.mark.parametrize("line", ["stats", "stats --live", "search gens=1", "serve start",
                                  "fleet start replicas=2"])
def test_unported_commands_print_one_line(cluster4, line, monkeypatch):
    command = line.split(" ")[0]
    if line == "stats":
        # ported since: the registry as Prometheus text (a fresh one here)
        monkeypatch.setattr(obs.registry, "_default", MetricsRegistry())
        got = drive(cluster4, ["actual-order attack", line])[5:]
        assert "# TYPE round_wall_s histogram" in got and "round_wall_s_count 1" in got
        assert not any("not ported" in ln for ln in got)
        return
    if line == "stats --live":
        # ported since: one health sample, a line a derived value
        got = drive(cluster4, [line])
        assert got and all(" " in ln and "error" not in ln for ln in got)
        assert any(ln.startswith("rounds_total ") for ln in got)
        return
    if command == "serve":
        # ported since: one line, the service's start (on the backend's
        # device; a backend without one asks for the card, which this
        # machine may lack) or the error that says why it did not start
        got = drive(cluster4, [line])
        assert len(got) == 1 and got[0].startswith(("serve: started (", "serve error: "))
        assert "not ported" not in got[0]
        drive(cluster4, ["serve stop"])
        return
    if command == "search":
        # ported since: the hunt's two lines on a backend that searches
        # (the torch backend on the CPU), none on PyBackend
        got = drive(cluster4, [line])
        if isinstance(cluster4.backend, PyBackend):
            assert got == []
        else:
            assert len(got) == 2 and got[0].startswith("Search: generations=1, campaigns=32")
            assert got[1].startswith("Search found: ")
        return
    # fleet, ported since: one line, the fleet's start on the backend's
    # device (the card for PyBackend, which this machine may lack) or the
    # error that says why it did not start
    got = drive(cluster4, [line])
    assert len(got) == 1 and got[0].startswith(("fleet: started 2 replica(s)", "fleet error: "))
    assert "not ported" not in got[0]
    drive(cluster4, ["fleet stop"])


@pytest.mark.parametrize("tokens", ["supervise", "mesh=1 supervise", "{ck} 2 supervise"])
def test_unported_scenario_tokens_print_one_line(cluster4, tokens, tmp_path):
    """Ported since: ``scenario <file> ... supervise`` prints the JAX
    package's lines (on PyBackend none, as it runs no scenarios; on the
    torch backend the campaign's, ending in its ``Scenario supervisor:``
    line) and leaves the same roster."""
    from ba_tpu.runtime.backends import JaxBackend
    from ba_tpu.runtime.backends import PyBackend as JPyBackend
    from ba_tpu.runtime.cluster import Cluster as JCluster
    from ba_tpu.runtime.repl import handle_command as j_handle

    spec = ROOT / "examples" / "scenarios" / "cascading_failover.json"
    script = [f"scenario {spec} " + tokens.format(ck=tmp_path / "ck.npz"), "g-state"]
    on_device = hasattr(cluster4.backend, "device")
    ref = JCluster(4, JaxBackend(platform="cpu") if on_device else JPyBackend(), seed=0)
    got = drive(cluster4, script)
    want = []
    for line in script:
        j_handle(ref, line, want.append)
    assert got == want
    assert [g.id for g in cluster4.generals] == [g.id for g in ref.generals]
    if on_device:
        sup = [ln for ln in got if ln.startswith("Scenario supervisor:")]
        assert sup == ["Scenario supervisor: attempts=1, retries=0, recoveries=0, stalls=0"]


def test_scenario_mesh_tokens(cluster4):
    """``mesh=1`` prints what the command prints without it; ``mesh=2``
    prints one error line naming both counts (the backend is one device)
    and runs nothing; PyBackend ignores the command, as without mesh=."""
    spec = ROOT / "examples" / "scenarios" / "cascading_failover.json"
    twin = Cluster(4, type(cluster4.backend)(**({"device": "cpu"}
                                                if hasattr(cluster4.backend, "device")
                                                else {})), seed=0)
    assert drive(cluster4, [f"scenario {spec} mesh=2"]) == (
        ["scenario error: mesh shape (2, 1) needs 2 device(s) but only 1 are available — "
         "shrink the shape or pass devices= with more entries (an entry may repeat a "
         "device)"] if hasattr(cluster4.backend, "device") else [])
    assert [g.id for g in cluster4.generals] == [1, 2, 3, 4]  # nothing ran
    assert drive(cluster4, [f"scenario {spec} mesh=1", "g-state"]) == \
        drive(twin, [f"scenario {spec}", "g-state"])


def test_run_rounds_on_a_signed_backend_prints_the_lane_line(monkeypatch):
    """A signed backend runs ``run-rounds`` through the signed pipelined
    engine: the round's block, the tally and the ``Signed lane:`` line,
    and no error line (the default signing pool without workers here)."""
    from ba_tpu_torch.crypto import pool

    monkeypatch.setattr(pool, "default_workers", lambda: 0)
    pool.shutdown_defaults()
    cluster = Cluster(4, TorchBackend(device="cpu", protocol="sm", signed=True), seed=0)
    out = drive(cluster, ["run-rounds attack 2"])
    assert len(out) == 7 and not any("error" in line for line in out)
    assert out[5] == "Rounds: 2 - attack=2, retreat=0, undefined=0"
    assert out[6].startswith("Signed lane: sign_ahead_s=") and out[6].endswith(", dispatches=1")
    assert cluster._round == 2


def test_run_rounds_fault_on_an_unsigned_backend_raises(monkeypatch):
    """Only the signed backend's refusal prints as one line; any other
    ValueError from the pipelined run is a fault and propagates."""
    def fault(*args, **kwargs):
        raise ValueError("a fault inside the pipelined run")

    backend = TorchBackend(device="cpu")
    monkeypatch.setattr(backend, "run_rounds", fault)
    with pytest.raises(ValueError, match="a fault inside"):
        drive(Cluster(4, backend, seed=0), ["run-rounds attack 2"])


def test_cuda_backend_without_a_card_exits_with_the_device_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["3"], ["3", "--backend", "cuda"]):
        with pytest.raises(SystemExit) as exc:
            build_cluster(argv)
        assert exc.value.code == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_cli_subprocess_torch_backend():
    """The launcher contract (stdin -> stdout) on the CPU's torch backend."""
    proc = subprocess.run(
        [sys.executable, "-m", "ba_tpu_torch.runtime.main", "3", "--backend", "torch"],
        input="g-state\nactual-order attack\nstats\nExit\n",
        capture_output=True,
        text=True,
        timeout=120,
        cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "G1, primary, state=NF",
        "G2, secondary, state=NF",
        "G3, secondary, state=NF",
        "G1, primary, majority=attack, state=NF",
        "G2, secondary, majority=attack, state=NF",
        "G3, secondary, majority=attack, state=NF",
        "Execute order: attack! Non-faulty nodes in the system"
        " - 2 out of 3 quorum suggests attack",
    ] + proc.stdout.splitlines()[7:]
    # ported since: ``stats`` prints the registry (a fresh process: one
    # election, one round, one compile span)
    stats = proc.stdout.splitlines()[7:]
    for line in ("# TYPE elections_total counter", "elections_total 1",
                 "round_wall_s_count 1", "compile_time_s_count 1"):
        assert line in stats, stats


SERVE_SCRIPT = ["serve", "serve stat", "serve start queue=4 window=0.01 batch=2",
                "serve start", "serve stat", "serve start queue=x", "serve stop", "serve bogus",
                "serve start batch=x", "serve start nope=1"]


def _serve_lines(handle, cluster, script):
    blocks = []
    for line in script:
        out = []
        handle(cluster, line, out.append)
        blocks.append(out)
    return blocks


def test_serve_command_prints_the_reference_lines(monkeypatch):
    """``serve start|stat|stop`` through ``handle_command`` on the CPU:
    every line the JAX package's (its REPL on its CPU engine), the
    ``serve_engine`` value and the usage's engine list the port's tokens."""
    from ba_tpu.crypto import pool as j_pool
    from ba_tpu.runtime.backends import PyBackend as JPyBackend
    from ba_tpu.runtime.cluster import Cluster as JCluster
    from ba_tpu.runtime.repl import handle_command as j_handle
    from ba_tpu_torch.crypto import pool as t_pool

    monkeypatch.setenv("BA_TPU_SIGN_POOL", "0")
    j_pool.shutdown_defaults()
    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    t_pool.shutdown_defaults()
    got = _serve_lines(handle_command, Cluster(4, TorchBackend(device="cpu"), seed=0),
                       SERVE_SCRIPT)
    want = _serve_lines(j_handle, JCluster(4, JPyBackend(), seed=0), SERVE_SCRIPT)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if SERVE_SCRIPT[i] == "serve stat":
            assert [ln.split(" ")[0] for ln in g] == [ln.split(" ")[0] for ln in w]
            fixed = {"serve_engine", "serve_batch_s_ewma"}
            assert [ln for ln in g if ln.split(" ")[0] not in fixed] == [
                ln for ln in w if ln.split(" ")[0] not in fixed]
            assert len(g) == 1 or "serve_engine auto" in g
        else:
            assert g == [ln.replace("xla|pallas|interpret|auto", "torch|cuda|auto")
                         for ln in w], SERVE_SCRIPT[i]
    assert got[2] == ["serve: started (queue=4, window=0.01s, batch=2)"]
    assert got[6][0].startswith("serve: stopped — admitted=0")


def test_serve_command_runs_requests_and_warm_start(monkeypatch):
    from ba_tpu_torch.crypto import pool as t_pool
    from ba_tpu_torch.runtime.serve import AgreementRequest

    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    t_pool.shutdown_defaults()
    cluster = Cluster(4, TorchBackend(device="cpu"), seed=0)
    assert drive(cluster, ["serve start warm=1 batch=1 engine=torch"]) == [
        "serve: started (queue=64, window=0.005s, batch=1, warm)"]
    svc = cluster._serve_service
    assert svc.warm_barrier(timeout=300)
    out = svc.submit(AgreementRequest(kind="run-rounds", n=4, faulty=(2,), seed=3,
                                      rounds=8)).result(timeout=300)
    assert out["counts"]["attack"] == 8
    stat = drive(cluster, ["serve stat"])
    assert "serve_completed 1" in stat and "serve_warmup_pending 0" in stat
    assert "serve_compiles_on_request_path 0" in stat and "serve_engine torch" in stat
    assert drive(cluster, ["serve stop"]) == [
        "serve: stopped — admitted=1, completed=1, rejected=0, expired=0, failed=0"]
    assert drive(cluster, ["serve start engine=xla"]) == [
        "serve error: engine='xla' not in ('torch', 'cuda', 'auto')"]


STATS_SCRIPT = ["actual-order attack", "g-kill 1", "actual-order attack", "g-add 2",
                "actual-order retreat", "g-kill 2", "stats"]


def _stats_view(lines):
    """The counter lines of the cluster's counters, and each histogram's
    name and count (its buckets and sum hold wall times)."""
    counters = [ln for ln in lines if ln.split(" ")[0] in ("elections_total",
                                                           "failover_kills_total")]
    counts = sorted(ln for ln in lines if ln.split(" ")[0].endswith("_count"))
    return counters, counts


@pytest.mark.parametrize("backend", ["py", "torch"])
def test_stats_prints_the_reference_counters_and_histograms(backend, monkeypatch):
    """Ported since: ``stats`` after the same commands prints the JAX
    package's counter lines and histogram names and counts (fresh
    registries in both packages; the port's torch backend against the
    reference's ``JaxBackend`` on the CPU)."""
    from ba_tpu import obs as j_obs
    from ba_tpu.obs.registry import MetricsRegistry as JRegistry
    from ba_tpu.runtime import backends as j_backends
    from ba_tpu.runtime.cluster import Cluster as JCluster
    from ba_tpu.runtime.repl import handle_command as j_handle

    monkeypatch.setattr(obs.registry, "_default", MetricsRegistry())
    monkeypatch.setattr(j_obs.registry, "_default", JRegistry())
    if backend == "py":
        ours, theirs = PyBackend(), j_backends.PyBackend()
    else:
        ours, theirs = TorchBackend(device="cpu"), j_backends.JaxBackend(platform="cpu")
    got = drive(Cluster(4, ours, seed=0), STATS_SCRIPT)
    want = []
    jc = JCluster(4, theirs, seed=0)
    for line in STATS_SCRIPT:
        j_handle(jc, line, want.append)
    assert got[:14] == want[:14]  # the rounds' lines
    view = _stats_view(got)
    assert view == _stats_view(want)
    assert view[0] == ["elections_total 3", "failover_kills_total 2"]
    assert "round_wall_s_count 3" in view[1]
    assert ("compile_time_s_count 2" in view[1]) == (backend == "torch")


def test_stats_fleet_prints_the_not_ported_line(cluster4):
    """Ported since: without a directory sink, ``stats --fleet`` prints
    the one line that differs from the JAX package's REPL (the port reads
    no ``BA_TPU_METRICS``: it names ``utils.metrics.configure``)."""
    from ba_tpu_torch.runtime.repl import FLEET_NO_SINK

    assert drive(cluster4, ["stats --fleet"]) == [FLEET_NO_SINK]
    assert FLEET_NO_SINK == ('fleet (no sharded sink — call '
                             'ba_tpu_torch.utils.metrics.configure("<dir>/"))')
