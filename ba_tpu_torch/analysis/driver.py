"""ba-lint driver: file discovery, the two-phase run, output, exit code
(``ba_tpu/analysis/driver.py``; the same CLI, JSON and SARIF).

``python -m ba_tpu_torch.analysis [paths] [--format human|json]
[--rules ...] [--exclude PATH] [--sarif OUT.sarif] [--list-rules]``

Phase one parses every ``.py`` under the given paths into
:class:`~ba_tpu_torch.analysis.project.ModuleInfo`; phase two builds the
:class:`~ba_tpu_torch.analysis.project.Project` (the import graph) and
runs every selected rule over every module.  Findings are filtered
through the per-file suppression index, sorted by location, and rendered
human-readable or as one JSON object (schema below).

Exit code: 1 if any unsuppressed ERROR-severity finding (including
syntax errors, reported as ``BA900``), else 0.  Warnings print and
count but never fail the run.

JSON schema (version 1)::

    {"version": 1, "tool": "ba-lint", "files_scanned": N,
     "rules": ["BA101", ...],
     "findings":   [{"code", "severity", "path", "line", "col",
                     "message"}, ...],
     "suppressed": [...same shape...],
     "counts": {"error": E, "warning": W, "suppressed": S},
     "exit": 0 | 1}
"""

from __future__ import annotations

import argparse
import json
import os

from ba_tpu_torch.analysis.base import ERROR, Finding, all_rules
from ba_tpu_torch.analysis.project import ModuleInfo, Project

JSON_SCHEMA_VERSION = 1
PARSE_ERROR_CODE = "BA900"

_SKIP_DIRS = {"__pycache__", ".git"}


def discover(paths, exclude=()) -> list:
    """``(abs_path, display_path)`` for every ``.py`` under ``paths``.

    ``exclude`` entries are file-or-directory path prefixes (resolved
    absolute, so ``tests/fixtures/ba_lint`` works from the repo root):
    anything at or under one is skipped: "lint ``tests/`` but not the
    deliberately violating lint fixtures".
    """
    out = []
    seen = set()
    excluded = tuple(os.path.abspath(e) for e in exclude)

    def is_excluded(ap: str) -> bool:
        return any(
            ap == e or ap.startswith(e + os.sep) for e in excluded
        )

    def add(p: str) -> None:
        ap = os.path.abspath(p)
        if ap in seen or is_excluded(ap):
            return
        seen.add(ap)
        rel = os.path.relpath(ap)
        out.append((ap, rel if not rel.startswith("..") else ap))

    for path in paths:
        if os.path.isfile(path):
            add(path)
            continue
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no such file or directory: {path}")
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d
                for d in dirs
                if d not in _SKIP_DIRS
                and not d.startswith(".")
                and not is_excluded(os.path.abspath(os.path.join(root, d)))
            )
            for f in sorted(files):
                if f.endswith(".py"):
                    add(os.path.join(root, f))
    return sorted(out, key=lambda t: t[1])


def run_paths(paths, rule_codes=None, exclude=()):
    """Analyze ``paths``; returns ``(findings, suppressed, files_scanned)``.

    ``findings``/``suppressed`` are location-sorted :class:`Finding`
    lists; ``rule_codes`` (e.g. ``{"BA101"}``) restricts the rule set;
    ``exclude`` prunes path prefixes from discovery (see
    :func:`discover`).
    """
    rules = [
        r
        for r in all_rules()
        if rule_codes is None or r.code in rule_codes
    ]
    modules = []
    findings = []
    for ap, disp in discover(paths, exclude):
        with open(ap, encoding="utf-8") as fh:
            source = fh.read()
        try:
            modules.append(ModuleInfo.parse(ap, disp, source))
        except SyntaxError as exc:
            findings.append(
                Finding(
                    code=PARSE_ERROR_CODE,
                    severity=ERROR,
                    path=disp,
                    line=exc.lineno or 1,
                    col=(exc.offset or 1) - 1,
                    message=f"syntax error: {exc.msg}",
                )
            )
    project = Project(modules)
    for mod in modules:
        for rule in rules:
            findings.extend(rule.check_module(mod, project))

    by_path = {m.display_path: m for m in modules}
    active, suppressed = [], []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressions.is_suppressed(
            f.code, f.line
        ):
            suppressed.append(f)
        else:
            active.append(f)
    key = lambda f: (f.path, f.line, f.col, f.code)  # noqa: E731
    return sorted(active, key=key), sorted(suppressed, key=key), len(
        modules
    )


def _to_json(active, suppressed, files, rules) -> dict:
    errors = sum(1 for f in active if f.severity == ERROR)
    warnings = len(active) - errors
    return {
        "version": JSON_SCHEMA_VERSION,
        "tool": "ba-lint",
        "files_scanned": files,
        "rules": [r.code for r in rules],
        "findings": [f.to_json() for f in active],
        "suppressed": [f.to_json() for f in suppressed],
        "counts": {
            "error": errors,
            "warning": warnings,
            "suppressed": len(suppressed),
        },
        "exit": 1 if errors else 0,
    }


def _to_sarif(active, suppressed, rules) -> dict:
    """SARIF 2.1.0 (the static-analysis interchange format CI code
    scanners ingest): one run, one ``result`` per finding — suppressed
    findings are carried too, marked ``suppressions: [{"kind":
    "inSource"}]``, so a waiver shows up in review instead of
    vanishing.  ``level`` maps error→error, warning→warning.  The
    rules array covers every SELECTED rule plus any extra code present
    in the results (BA900 parse errors have no Rule object)."""
    descriptors = {
        r.code: {
            "id": r.code,
            "name": r.name,
            "defaultConfiguration": {
                "level": "error" if r.severity == ERROR else "warning"
            },
        }
        for r in rules
    }
    for f in list(active) + list(suppressed):
        descriptors.setdefault(
            f.code,
            {
                "id": f.code,
                "name": "parse-error"
                if f.code == PARSE_ERROR_CODE
                else f.code,
                "defaultConfiguration": {"level": "error"},
            },
        )

    def result(f: Finding, in_source_suppressed: bool) -> dict:
        out = {
            "ruleId": f.code,
            "level": "error" if f.severity == ERROR else "warning",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace(os.sep, "/")
                        },
                        "region": {
                            "startLine": f.line,
                            # SARIF columns are 1-based; Finding.col
                            # is the 0-based ast col_offset.
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if in_source_suppressed:
            out["suppressions"] = [{"kind": "inSource"}]
        return out

    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "ba-lint",
                        "informationUri": (
                            "https://github.com/ba-tpu/ba-tpu"
                        ),
                        "rules": [
                            descriptors[c] for c in sorted(descriptors)
                        ],
                    }
                },
                "results": [result(f, False) for f in active]
                + [result(f, True) for f in suppressed],
            }
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ba_tpu_torch.analysis",
        description=(
            "ba-lint for the PyTorch port: AST analyzer of host syncs, "
            "in-place carries, key reuse, obs purity, threads and "
            "contracts (standard library only; never imports torch)"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["."],
        help="files or directories to analyze (default: .)",
    )
    parser.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        help="output format (json: one schema-versioned object)",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated rule codes to run (default: all)",
    )
    parser.add_argument(
        "--exclude",
        action="append",
        default=[],
        metavar="PATH",
        help="path prefix to skip (repeatable): e.g. "
             "--exclude tests/fixtures/ba_lint_torch keeps the "
             "deliberately violating fixtures out of a tests/ lint run",
    )
    parser.add_argument(
        "--sarif",
        metavar="OUT.sarif",
        help="ALSO write findings as SARIF 2.1.0 to this path "
             "(composes with either --format; suppressed findings "
             "are included, marked suppressions=inSource)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.code}  {r.severity:7s}  {r.name}")
        return 0
    selected = None
    if args.rules:
        selected = {c.strip().upper() for c in args.rules.split(",")}
        known = {r.code for r in rules}
        bad = selected - known
        if bad:
            parser.error(
                f"unknown rule code(s): {', '.join(sorted(bad))} "
                f"(known: {', '.join(sorted(known))})"
            )
    try:
        active, suppressed, files = run_paths(
            args.paths, selected, exclude=args.exclude
        )
    except FileNotFoundError as exc:
        parser.error(str(exc))

    run_rules = [r for r in rules if selected is None or r.code in selected]
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(
                _to_sarif(active, suppressed, run_rules), fh, indent=2
            )
            fh.write("\n")
    if args.format == "json":
        print(json.dumps(_to_json(active, suppressed, files, run_rules)))
    else:
        for f in active:
            print(f.render())
        errors = sum(1 for f in active if f.severity == ERROR)
        warnings = len(active) - errors
        print(
            f"ba-lint: {errors} error(s), {warnings} warning(s)"
            f" ({len(suppressed)} suppressed) across {files} file(s)"
        )
    return 1 if any(f.severity == ERROR for f in active) else 0
