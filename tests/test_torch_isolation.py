"""The port stands alone: it loads neither jax nor ``ba_tpu``, and it never
carries on silently on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from ba_tpu_torch.core import rng, state
from ba_tpu_torch.parallel import pipeline

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "ba_tpu_torch"
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"
MODULES = sorted(
    ".".join(p.relative_to(PACKAGE.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)


def _foreign(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name.startswith("jaxlib") \
        or name == "ba_tpu" or name.startswith("ba_tpu.")


def test_importing_every_module_loads_no_jax_and_no_ba_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'ba_tpu' or m.startswith('ba_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ("ba_tpu_torch.ops.scenario_step", "ba_tpu_torch.utils.snapshot",
                 "ba_tpu_torch.obs.flight", "ba_tpu_torch.scenario.__main__",
                 "ba_tpu_torch.runtime.backends", "ba_tpu_torch.runtime.cluster",
                 "ba_tpu_torch.runtime.repl", "ba_tpu_torch.runtime.main",
                 "ba_tpu_torch.crypto.pool", "ba_tpu_torch.crypto.tables",
                 "ba_tpu_torch.parallel.signing", "ba_tpu_torch.parallel.mesh",
                 "ba_tpu_torch.parallel.multihost", "ba_tpu_torch.parallel.shard",
                 "ba_tpu_torch.parallel.node_parallel", "ba_tpu_torch.parallel.eig_parallel",
                 "ba_tpu_torch.parallel.sm_parallel", "ba_tpu_torch.utils.metrics",
                 "ba_tpu_torch.obs.registry", "ba_tpu_torch.obs.trace",
                 "ba_tpu_torch.obs.health", "ba_tpu_torch.obs.graphcache",
                 "ba_tpu_torch.runtime.supervisor", "ba_tpu_torch.runtime.chaos",
                 "ba_tpu_torch.runtime.warmup", "ba_tpu_torch.runtime.serve",
                 "ba_tpu_torch.obs.slo", "ba_tpu_torch.obs.instrument",
                 "ba_tpu_torch.obs.cuda", "ba_tpu_torch.obs.fleet",
                 "ba_tpu_torch.search", "ba_tpu_torch.search.__main__",
                 "ba_tpu_torch.search.generate", "ba_tpu_torch.search.objective",
                 "ba_tpu_torch.search.corpus", "ba_tpu_torch.search.loop",
                 "ba_tpu_torch.search.minimize", "ba_tpu_torch.fleet",
                 "ba_tpu_torch.fleet.replica", "ba_tpu_torch.fleet.router",
                 "ba_tpu_torch.fleet.migrate", "ba_tpu_torch.analysis",
                 "ba_tpu_torch.analysis.__main__", "ba_tpu_torch.analysis.base",
                 "ba_tpu_torch.analysis.suppress", "ba_tpu_torch.analysis.resolver",
                 "ba_tpu_torch.analysis.flow", "ba_tpu_torch.analysis.project",
                 "ba_tpu_torch.analysis.contracts", "ba_tpu_torch.analysis.driver",
                 "ba_tpu_torch.analysis.rules", "ba_tpu_torch.analysis.rules.dead_imports",
                 "ba_tpu_torch.analysis.rules.hot_path", "ba_tpu_torch.analysis.rules.donation",
                 "ba_tpu_torch.analysis.rules.rng", "ba_tpu_torch.analysis.rules.obs_purity",
                 "ba_tpu_torch.analysis.rules.concurrency",
                 "ba_tpu_torch.analysis.rules.contracts_rules"):
        assert name in MODULES, name


def test_the_supervisor_and_the_flight_recorder_load_no_jax():
    """The supervised campaign's modules alone, in a fresh process."""
    code = (
        "import sys\n"
        "import ba_tpu_torch.runtime.supervisor, ba_tpu_torch.obs.flight\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'ba_tpu' or m.startswith('ba_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_module_imports_jax_or_ba_tpu():
    """The AST scan covers every module of the package and chip_smoke.py,
    which runs on the card's machine, where there is no jax."""
    for path in [*PACKAGE.rglob("*.py"), CHIP_SMOKE]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_foreign(n) for n in names), (path, names)


def test_no_module_reads_the_environment():
    """The JAX package's environment knobs are keywords in the port (the
    run id is ``pipeline_sweep(run_id=...)``)."""
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv", "environb"), path


def test_scenario_cli_loads_no_jax_and_no_torch():
    """``python -m ba_tpu_torch.scenario`` on the committed specs: numpy
    and the stdlib only."""
    specs = sorted(str(p) for p in (PACKAGE.parent / "examples" / "scenarios").glob("*.json"))
    code = ("import runpy, sys\n"
            f"sys.argv = ['scenario', *{specs!r}]\n"
            "try:\n"
            "    runpy.run_module('ba_tpu_torch.scenario', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ba_tpu', 'torch'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(specs) >= 2 and proc.stdout.count(": OK") == len(specs)


def test_slo_cli_and_the_obs_package_load_no_torch():
    """``python -m ba_tpu_torch.obs.slo`` (stdlib only), and the obs
    package with its device tier (``obs.cuda``, ``obs.instrument``)
    imported: no torch, no numpy, no jax."""
    policy = str(PACKAGE.parent / "examples" / "slo" / "serving.json")
    code = ("import runpy, sys\n"
            "import ba_tpu_torch.obs, ba_tpu_torch.obs.cuda, ba_tpu_torch.obs.instrument\n"
            f"sys.argv = ['slo', 'validate', {policy!r}]\n"
            "try:\n"
            "    runpy.run_module('ba_tpu_torch.obs.slo', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ba_tpu', 'torch', 'numpy'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(": OK") == 1


def _run_module_code(module: str, argv: list, forbidden: tuple) -> str:
    return ("import runpy, sys\n"
            f"sys.argv = {[module, *argv]!r}\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{forbidden!r})\n"
            "assert not bad, bad\n")


def test_search_cli_loads_no_torch():
    """``python -m ba_tpu_torch.search corpus`` on the committed corpus and
    ``sample`` on a space: numpy and the stdlib only."""
    found = str(PACKAGE.parent / "examples" / "scenarios" / "found")
    proc = subprocess.run(
        [sys.executable, "-c",
         _run_module_code("ba_tpu_torch.search", ["corpus", found],
                          ("jax", "jaxlib", "ba_tpu", "torch"))],
        capture_output=True, text=True, cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "corpus OK" in proc.stdout


def test_fleet_cli_and_the_fleet_package_load_no_torch(tmp_path):
    """``python -m ba_tpu_torch.obs.fleet <dir>`` (stdlib only: no torch,
    no numpy) and ``import ba_tpu_torch.fleet`` (no torch)."""
    sink = tmp_path / "sink"
    sink.mkdir()
    (sink / "1.run-a.jsonl").write_text(
        '{"event": "clock_anchor", "perf_t": 1.0, "ts": 100.0}\n'
        '{"event": "request", "id": 1, "trace_id": "' + "a" * 32 + '", "span_id": "'
        + "b" * 16 + '", "status": "ok", "wall_s": 0.5, "queue_s": 0.1, "coalesce_s": 0.1, '
        '"compile_s": 0.0, "dispatch_s": 0.2, "retire_lag_s": 0.1}\n')
    proc = subprocess.run(
        [sys.executable, "-c",
         _run_module_code("ba_tpu_torch.obs.fleet", [str(sink)],
                          ("jax", "jaxlib", "ba_tpu", "torch", "numpy"))],
        capture_output=True, text=True, cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"all_spans_parented": true' in proc.stdout
    code = ("import sys\n"
            "import ba_tpu_torch.fleet\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ba_tpu', 'torch'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        state.make_state(2, 4)
    with pytest.raises(RuntimeError):
        rng.key(0)
    cpu_state = state.make_state(2, 4, device="cpu")
    with pytest.raises(RuntimeError):
        pipeline.pipeline_sweep(rng.key(0, device="cpu"), cpu_state, 2)


def test_cuda_engine_on_cpu_raises():
    cpu_state = state.make_state(2, 4, device="cpu")
    with pytest.raises(ValueError):
        pipeline.pipeline_sweep(rng.key(0, device="cpu"), cpu_state, 2,
                                engine="cuda", device="cpu")
    assert pipeline.resolve_engine(None, torch.device("cpu")) == "torch"
    assert pipeline.resolve_engine(None, torch.device("cuda")) == "cuda"
    with rng.partitionable(False):
        with pytest.raises(ValueError):
            pipeline.resolve_engine("cuda", torch.device("cuda"))
