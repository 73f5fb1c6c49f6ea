"""ba-lint for the port (``ba_tpu_torch/analysis``): fixtures, the
self-lint of the lint set, the CLI contract, and agreement with
``ba_tpu.analysis`` where the rules carry over as they are.

- **Fixture exactness**: every ``# expect: BAxxx`` marker in
  ``tests/fixtures/ba_lint_torch/.cases/`` is matched by a finding at that
  (file, line) and every finding by a marker.
- **Self-lint**: the lint set (``ba_tpu_torch chip_smoke.py
  tests/test_torch_*.py``) has no finding of any severity, and every
  suppression in it names its code and a reason.
- **CLI**: exit codes, the version-1 JSON, SARIF 2.1.0, ``--rules``,
  ``--exclude``, and a run that loads no torch, numpy or jax.
- **Against the reference**: on the reference's package-neutral fixtures
  (BA401, BA501–BA504) both analyzers report the same findings.
"""

import ast
import glob
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

import ba_tpu.analysis as j_analysis
from ba_tpu_torch.analysis import contracts, run_paths
from ba_tpu_torch.analysis.base import all_rules
from ba_tpu_torch.analysis.resolver import module_name

REPO = pathlib.Path(__file__).resolve().parent.parent
# The cases sit in a dot-directory: ba_tpu's own lint of tests/ (which
# excludes only tests/fixtures/ba_lint) skips dot-directories.
FIXTURES = REPO / "tests" / "fixtures" / "ba_lint_torch" / ".cases"
REFERENCE_FIXTURES = REPO / "tests" / "fixtures" / "ba_lint"
LINT_SET = ["ba_tpu_torch", "chip_smoke.py",
            *sorted(str(pathlib.Path(p).relative_to(REPO))
                    for p in glob.glob(str(REPO / "tests" / "test_torch_*.py")))]
CODES = {"BA101", "BA102", "BA201", "BA202", "BA301", "BA401", "BA501", "BA502",
         "BA503", "BA504", "BA601", "BA602", "BA603"}
_EXPECT_RE = re.compile(r"#\s*expect:\s*((?:BA\d+\s*)+)")
_WAIVER_RE = re.compile(r"#\s*ba-lint:\s*disable=(BA\d+(?:,\s*BA\d+)*)\s+\((\S[^)]*)\)")


def _expected_markers():
    expected = set()
    for path in sorted(FIXTURES.rglob("*.py")):
        rel = str(path.relative_to(REPO))
        for lineno, text in enumerate(path.read_text().splitlines(), start=1):
            m = _EXPECT_RE.search(text)
            if m:
                expected |= {(rel, lineno, code) for code in m.group(1).split()}
    return expected


def _rel(path: str) -> str:
    return str((pathlib.Path.cwd() / path).resolve().relative_to(REPO))


def _run_cli(args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "ba_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=str(cwd), timeout=120)


def _package(tmp_path, module: str, source: str):
    """``module`` (dotted, under ba_tpu_torch) written into a fresh tree."""
    parts = module.split(".")
    d = tmp_path
    for part in parts[:-1]:
        d = d / part
        d.mkdir(exist_ok=True)
        (d / "__init__.py").touch()
    (d / f"{parts[-1]}.py").write_text(source)
    return d / f"{parts[-1]}.py"


@pytest.fixture(scope="module")
def self_lint():
    return run_paths([str(REPO / p) for p in LINT_SET])


def test_fixture_findings_exact():
    expected = _expected_markers()
    assert len(expected) > 60
    active, suppressed, files = run_paths([str(FIXTURES)])
    actual = {(_rel(f.path), f.line, f.code) for f in active}
    assert not expected - actual, f"missed: {sorted(expected - actual)}"
    assert not actual - expected, f"false positives: {sorted(actual - expected)}"
    assert {f.code for f in suppressed} == {"BA101", "BA201", "BA202", "BA501", "BA502"}
    assert files >= 25
    assert {code for _, _, code in expected} == CODES


def test_self_lint_of_the_lint_set_is_finding_free(self_lint):
    active, _, files = self_lint
    assert files > 130
    assert not active, "\n".join(f.render() for f in active)


def test_every_suppression_names_its_code_and_reason(self_lint):
    _, suppressed, _ = self_lint
    assert len(suppressed) >= 15
    for f in suppressed:
        line = (pathlib.Path.cwd() / f.path).read_text().splitlines()[f.line - 1]
        m = _WAIVER_RE.search(line)
        assert m and f.code in m.group(1), f"{f.path}:{f.line}: {line.strip()}"
    # The sanctioned retire sync and the health sampler's counter are there.
    where = {(pathlib.Path(f.path).name, f.code) for f in suppressed}
    assert ("pipeline.py", "BA101") in where and ("health.py", "BA502") in where


def test_cli_on_the_lint_set_loads_no_torch_numpy_or_jax(tmp_path):
    """The card's machine runs the analyzer as chip_smoke's phase 50 does:
    exit 0, the schema fields, SARIF 2.1.0 with the 13 rules, and nothing
    of torch, numpy, jax or ba_tpu in the process."""
    sarif = tmp_path / "lint.sarif"
    code = textwrap.dedent(f"""
        import contextlib, io, json, sys
        from ba_tpu_torch.analysis import main
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main({LINT_SET!r} + ["--format", "json", "--sarif", {str(sarif)!r}])
        banned = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("torch", "numpy", "jax", "jaxlib", "ba_tpu"))
        print(json.dumps({{"rc": rc, "doc": json.loads(out.getvalue()), "banned": banned}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["rc"] == 0 and got["banned"] == []
    doc = got["doc"]
    for field in ("version", "tool", "files_scanned", "rules", "findings", "suppressed",
                  "counts", "exit"):
        assert field in doc, field
    assert doc["version"] == 1 and doc["tool"] == "ba-lint" and doc["exit"] == 0
    assert doc["counts"]["error"] == doc["counts"]["warning"] == 0
    assert set(doc["rules"]) == CODES
    s = json.loads(sarif.read_text())
    assert s["version"] == "2.1.0"
    assert {r["id"] for r in s["runs"][0]["tool"]["driver"]["rules"]} == CODES
    assert all(r.get("suppressions") == [{"kind": "inSource"}] for r in s["runs"][0]["results"])


def test_the_build_helper_is_host_tier_and_loads_no_torch():
    """BA301 treats ``ops/_build.py`` as host tier: loaded alone it pulls
    in no torch (its imports are the standard library's)."""
    path = REPO / "ba_tpu_torch" / "ops" / "_build.py"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('_build_alone', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'ba_tpu', 'ba_tpu_torch'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    from ba_tpu_torch.analysis.rules import obs_purity
    assert "ba_tpu_torch.ops._build" in obs_purity.HOST_IN_DEVICE_TREE
    assert "ba_tpu_torch.obs.graphcache" in obs_purity.OBS_DEVICE_SEAMS


@pytest.mark.parametrize("name", ["ba401.py", "ba501.py", "ba502.py", "ba503.py",
                                  "ba504.py"])
def test_port_agrees_with_reference_on_neutral_fixtures(name):
    path = str(REFERENCE_FIXTURES / name)
    codes = {"BA401", "BA501", "BA502", "BA503", "BA504"}

    def findings(run):
        active, suppressed, _ = run([path], rule_codes=codes)
        return [(f.code, f.line, f.col, f.message) for f in active + suppressed]

    want = findings(j_analysis.run_paths)
    assert want and findings(run_paths) == want


def test_module_name_scoping_survives_tree_copies(tmp_path):
    target = _package(tmp_path, "ba_tpu_torch.parallel.pipeline",
                      "def f(ev):\n    ev.synchronize()\n")
    assert module_name(str(target)) == "ba_tpu_torch.parallel.pipeline"
    active, _, _ = run_paths([str(tmp_path)])
    assert [f.code for f in active] == ["BA101"]


def test_file_wide_suppression(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        # ba-lint: disable-file=BA202
        from ba_tpu_torch.core import rng

        def f(key):
            return rng.bits(key, (2,)), rng.coin_bits(key, (2,))
    """))
    active, suppressed, _ = run_paths([str(tmp_path)])
    assert not active and [s.code for s in suppressed] == ["BA202"]


def test_exclude_prunes_paths(tmp_path):
    _package(tmp_path, "ba_tpu_torch.parallel.pipeline", "def f(x):\n    return x.item()\n")
    (tmp_path / "clean.py").write_text("X = 1\n")
    active, _, files = run_paths([str(tmp_path)])
    assert [f.code for f in active] == ["BA101"] and files == 4
    active, _, files = run_paths([str(tmp_path)], exclude=[str(tmp_path / "ba_tpu_torch")])
    assert active == [] and files == 1
    proc = _run_cli([str(tmp_path), "--format", "json", "--exclude",
                     str(tmp_path / "ba_tpu_torch")])
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and doc["files_scanned"] == 1


def test_syntax_error_is_fatal_finding(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    active, _, _ = run_paths([str(tmp_path)])
    assert [f.code for f in active] == ["BA900"] and active[0].severity == "error"


def test_cli_json_schema_exit_codes_and_rule_filter(tmp_path):
    _package(tmp_path, "ba_tpu_torch.parallel.pipeline",
             "from ba_tpu_torch.core import rng\n\ndef f(key):\n    return rng.split(key)\n")
    proc = _run_cli([str(tmp_path), "--format", "json"])
    assert proc.returncode == 1, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["version"] == 1 and doc["tool"] == "ba-lint" and doc["exit"] == 1
    assert [f["code"] for f in doc["findings"]] == ["BA102"]
    for f in doc["findings"]:
        assert {"code", "severity", "path", "line", "col", "message"} <= set(f)
    proc = _run_cli([str(tmp_path), "--format", "json", "--rules", "BA101,BA301"])
    assert proc.returncode == 0
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and doc["rules"] == ["BA101", "BA301"]
    proc = _run_cli([str(tmp_path), "--rules", "BA999"])
    assert proc.returncode == 2 and "unknown rule code" in proc.stderr


def test_list_rules_covers_the_documented_set():
    proc = _run_cli(["--list-rules"])
    assert proc.returncode == 0
    assert {line.split()[0] for line in proc.stdout.splitlines() if line} == CODES
    severities = {r.code: r.severity for r in all_rules()}
    assert severities.pop("BA401") == "warning"
    assert set(severities.values()) == {"error"}


def test_every_rule_states_its_torch_meaning():
    """Each rule module's docstring names the reference module it ports
    and its torch meaning; every departure is marked as one."""
    from ba_tpu_torch.analysis import rules

    rules.load_all()
    seen = set()
    for rule in all_rules():
        doc = sys.modules[type(rule).__module__].__doc__
        assert rule.code in doc and "ba_tpu/analysis/rules/" in doc, rule.code
        seen.add(type(rule).__module__)
    departures = {m for m in seen if "Departure from the reference" in sys.modules[m].__doc__}
    assert departures == {f"ba_tpu_torch.analysis.rules.{m}" for m in
                          ("hot_path", "donation", "rng", "obs_purity", "contracts_rules")}


def test_warnings_do_not_fail_the_run(tmp_path):
    (tmp_path / "mod.py").write_text("import torch\n\nX = 1\n")
    proc = _run_cli([str(tmp_path), "--format", "json"])
    assert proc.returncode == 0
    doc = json.loads(proc.stdout)
    assert [f["code"] for f in doc["findings"]] == ["BA401"]
    assert doc["counts"] == {"error": 0, "warning": 1, "suppressed": 0}


def test_relative_import_anchoring_in_package_init(tmp_path):
    _package(tmp_path, "ba_tpu_torch.core.impure", "from ba_tpu_torch import obs as _o\n")
    (tmp_path / "ba_tpu_torch" / "core" / "__init__.py").write_text("from . import impure\n")
    active, _, _ = run_paths([str(tmp_path)], rule_codes={"BA301"})
    hits = {(pathlib.Path(f.path).name, f.code) for f in active}
    assert hits == {("impure.py", "BA301"), ("__init__.py", "BA301")}, hits


def test_match_statement_arms_are_flow_branches(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent("""
        from ba_tpu_torch.core import rng

        def rebound_in_every_arm(key, mode):
            a = rng.coin_bits(key, (2,))
            match mode:
                case 1:
                    key = rng.split(key)[0]
                case _:
                    key = rng.split(key)[1]
            return a, rng.bits(key, (2,))

        def double_draw_in_arm(key, mode):
            match mode:
                case 1:
                    a = rng.coin_bits(key, (2,))
                    b = rng.bits(key, (2,))
                    return a, b
            return None
    """))
    active, _, _ = run_paths([str(tmp_path)])
    assert [(f.code, f.line) for f in active] == [("BA202", 17)], active


def test_docstring_directives_and_trailing_disable_file_inert(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent('''
        """Docs: write `# ba-lint: disable-file=BA202` to waive a file."""
        from ba_tpu_torch.core import rng

        def f(key):
            a = rng.coin_bits(key, (2,))  # ba-lint: disable-file=BA202
            b = rng.bits(key, (2,))
            return a, b
    '''))
    active, suppressed, _ = run_paths([str(tmp_path)])
    assert [f.code for f in active] == ["BA202"] and not suppressed


def test_donates_annotation_cross_module(tmp_path):
    _package(tmp_path, "ba_tpu_torch.parallel.engine", textwrap.dedent('''
        """Docs may say `# ba-lint: donates(state)` without registering."""

        def run(  # ba-lint: donates(state)
            key, state, rounds,
        ):
            return state
    '''))
    _package(tmp_path, "ba_tpu_torch.parallel.caller", textwrap.dedent("""
        from ba_tpu_torch.parallel.engine import run as launch

        def bad(key, state):
            out = launch(key, state, 4)
            return out, state

        def key_is_fine(key, state):
            out = launch(key, state, 4)
            return out, key
    """))
    active, _, _ = run_paths([str(tmp_path)], rule_codes={"BA201"})
    assert [(pathlib.Path(f.path).name, f.line) for f in active] == [("caller.py", 6)]


def test_donates_annotation_typo_is_a_finding(tmp_path):
    (tmp_path / "m.py").write_text(
        "def run(state, sched):  # ba-lint: donates(sate)\n    return state\n")
    active, _, _ = run_paths([str(tmp_path)], rule_codes={"BA201"})
    assert [(f.code, f.line) for f in active] == [("BA201", 1)]
    assert "not positional parameters" in active[0].message


def test_the_port_annotates_every_in_place_megastep():
    """The reference's 15 annotations carried over to their counterparts,
    plus the torch megasteps of the plain and scenario engines."""
    from ba_tpu_torch.analysis.project import ModuleInfo
    from ba_tpu_torch.analysis.rules.donation import KNOWN_DONATING, annotated_donations

    specs = {}
    for path in (REPO / "ba_tpu_torch").rglob("*.py"):
        mod = ModuleInfo.parse(str(path), str(path), path.read_text())
        got, errors = annotated_donations(mod)
        assert not errors, (path, errors)
        specs.update(got)
    assert len(specs) == 16
    assert set(KNOWN_DONATING) <= set(specs)
    assert {f"ba_tpu_torch.runtime.supervisor.{f}"
            for f in ("supervised_sweep", "_supervised_sweep_impl")} <= set(specs)


MUTATIONS = {
    "BA101": ("ba_tpu_torch.parallel.sweep",
              "import torch.cuda as tc\n\ndef f():\n    tc.synchronize()\n"),
    "BA102": ("ba_tpu_torch.parallel.pipeline",
              "from ba_tpu_torch.core import rng as r\n\ndef f(k):\n    return r.split(k)\n"),
    "BA201": ("ba_tpu_torch.parallel.loop",
              "from ba_tpu_torch.ops.scenario_step import cuda_pipeline_megastep as m\n\n"
              "def f(state, sched):\n    out = m(state, sched, rounds=2)\n"
              "    return out, state.alive\n"),
    "BA202": ("ba_tpu_torch.search.draws",
              "from ba_tpu_torch.core import rng as r\n\n"
              "def f(k):\n    return r.coin_bits(k, (2,)), r.bits(k, (2,))\n"),
    "BA301": ("ba_tpu_torch.ops.kernel", "from ba_tpu_torch import obs as o\n\nX = o\n"),
    "BA401": ("ba_tpu_torch.utils.unused", "import torch as t\n\nX = 1\n"),
    "BA501": ("ba_tpu_torch.runtime.loop",
              "import threading as th\n\n\nclass M:\n    def start(self):\n"
              "        th.Thread(target=self._loop, daemon=True).start()\n\n"
              "    def _loop(self):\n        self.n = 1\n\n    def poke(self):\n"
              "        self.n = 2\n"),
    "BA502": ("ba_tpu_torch.obs.sampler",
              "# ba-lint: lockfree\n\n\nclass S:\n    def sample(self):\n"
              "        self.n += 1\n"),
    "BA503": ("ba_tpu_torch.obs.ledger",
              "import threading\n\n\nclass L:\n    def __init__(self):\n"
              "        self._m = threading.Lock()\n\n    def f(self):\n"
              "        with self._m:\n            with self._m:\n                pass\n"),
    "BA504": ("ba_tpu_torch.runtime.timers",
              "import threading as th\n\n\ndef f():\n    th.Timer(1.0, print).start()\n"),
    "BA601": ("ba_tpu_torch.runtime.records",
              "def f(sink):\n    sink.emit({'event': 'mystery_event', 'v': 1})\n"),
    "BA602": ("ba_tpu_torch.obs.names",
              "def f(reg):\n    return reg.gauge('depth_serve_live')\n"),
    "BA603": ("ba_tpu_torch.runtime.knobs",
              "import os as _o\n\n\ndef f():\n    return _o.environ.get('HOME')\n"),
}


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_mutation_flips_red(tmp_path, code):
    """A seeded violation of each rule goes red in the port's package
    scope, through an import alias where the rule resolves one."""
    module, source = MUTATIONS[code]
    _package(tmp_path, module, source)
    active, _, _ = run_paths([str(tmp_path)], rule_codes={code})
    assert active and {f.code for f in active} == {code}, active


def test_sarif_output_structure(tmp_path):
    out = tmp_path / "lint.sarif"
    proc = _run_cli([str(FIXTURES / "ba501.py"), str(FIXTURES / "ba601.py"),
                     "--sarif", str(out), "--format", "json"])
    assert proc.returncode == 1
    json.loads(proc.stdout)
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    (run,) = doc["runs"]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == CODES
    for r in run["results"]:
        assert r["ruleId"] in rule_ids and r["level"] in ("error", "warning")
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(".py")
        assert loc["region"]["startLine"] >= 1 and loc["region"]["startColumn"] >= 1
    assert any(r.get("suppressions") == [{"kind": "inSource"}] for r in run["results"])
    assert any("suppressions" not in r for r in run["results"])


def test_readme_keyword_table_names_reference_knobs():
    """The port documents no environment (``ENV_DOCUMENTED`` is empty):
    each reference knob is a keyword, and every row of the README's port
    keyword table names a knob of the reference's README table."""
    from ba_tpu.analysis import contracts as j_contracts

    assert contracts.ENV_DOCUMENTED == frozenset()
    readme = (REPO / "README.md").read_text()
    start = readme.index("| Reference knob | Port keyword |")
    rows = readme[start:readme.index("\n\n", start)].splitlines()[2:]
    knobs = {k for row in rows for k in re.findall(r"BA_TPU_[A-Z0-9_]+", row.split("|")[1])}
    assert "BA_TPU_STRATEGY_CHAIN" in knobs and len(rows) >= 10
    assert all(j_contracts.env_documented(k) for k in knobs), knobs


def test_contracts_registry_pins_runtime_tables():
    import ba_tpu.obs.flight as j_flight
    from ba_tpu.analysis import contracts as j_contracts
    from ba_tpu_torch.obs import flight
    from ba_tpu_torch.utils import metrics

    assert contracts.RUN_SCOPED_EVENTS == flight.RUN_SCOPED_EVENTS == j_flight.RUN_SCOPED_EVENTS
    assert contracts.SCHEMA_VERSION == metrics.SCHEMA_VERSION
    assert set(contracts.RECORD_FAMILIES) == set(j_contracts.RECORD_FAMILIES)
    assert contracts.metric_name_violation("serve_queue_depth") is None
    assert contracts.metric_name_violation("plane_bytes_per_shard") is None
    assert contracts.metric_name_violation("queue_serve_depth")
    assert contracts.metric_name_violation("per_shard_bytes")


def test_ba603_scope_is_the_package_and_chip_smoke(tmp_path):
    """Reads in a test or a script are not findings; ``chip_smoke.py``'s
    are, like the package's."""
    src = "import os\n\nHOME = os.environ.get('HOME')\n"
    (tmp_path / "test_something.py").write_text(src)
    (tmp_path / "chip_smoke.py").write_text(src)
    active, _, _ = run_paths([str(tmp_path)], rule_codes={"BA603"})
    assert [pathlib.Path(f.path).name for f in active] == ["chip_smoke.py"]


def test_the_analyzer_imports_the_standard_library_only():
    roots = set()
    for path in (REPO / "ba_tpu_torch" / "analysis").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "argparse", "ast", "dataclasses", "io", "json", "os",
                     "re", "sys", "tokenize", "ba_tpu_torch"}, roots
