"""BENCHMARK.json against the benchmark contract's syntax, and what the
harness finds by its names."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH_CHARS.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check with 24 cells fits its 43 200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        reported = {name for name, ws in e2e.items() if cell in ws}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_files_are_found_by_name():
    package = ROOT / "portbench"
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.suffix == ".json"
        assert any(Path(c["file"]).is_relative_to(p) for p in SPEC["paths"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(configs)
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        traffic = json.loads((package / "traffic" / f"{w['traffic']}.json").read_text())
        assert (package / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (package / "metrics" / f"{m['name']}.py").is_file()
    for f in package.rglob("*"):
        if "__pycache__" not in f.parts and "_cache" not in f.parts:
            assert PATH_CHARS.match(f.relative_to(ROOT).as_posix()), f


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_widths_are_published(name):
    """No cell cuts a configuration: reduced is empty and the files hold
    BASELINE config #5's widths."""
    c = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["reduced"] == []
    assert cfg["capacity"] == 1024 and cfg["batch"] >= 10000
