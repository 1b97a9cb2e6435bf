"""CLI driver of the port's host-sync lint (``repro.analysis.lint``'s
counterpart, with its flags, formats and exit codes).

    python -m repro_torch.analysis.lint [paths...] [--baseline FILE]
                                  [--format text|json]
                                  [--write-baseline FILE]

Exit status 0 when every active finding is grandfathered by the
baseline (or no baseline is given and there are no findings); 1 when
new findings exist; 2 on a parse error in a scanned file. Pure stdlib:
it imports no torch, so it runs where no accelerator stack is installed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import Finding, ModuleInfo
from repro_torch.analysis.rules import ALL_RULES, RULE_TITLES


def iter_py_files(paths: Sequence) -> List[Tuple[Path, str]]:
    """(abspath, relpath) for every .py under ``paths``. Relpaths are
    anchored at each scan root's parent (``lint src/repro_torch`` →
    ``repro_torch/...``)
    so fingerprints are stable regardless of the invocation directory."""
    out: List[Tuple[Path, str]] = []
    seen = set()
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        anchor = root if root.is_dir() else root.parent
        for f in files:
            f = f.resolve()
            if f in seen:
                continue
            seen.add(f)
            try:
                rel = f.relative_to(anchor.resolve().parent)
            except ValueError:
                rel = Path(f.name)
            out.append((f, rel.as_posix()))
    return out


def lint_file(path, relpath: Optional[str] = None,
              src: Optional[str] = None) -> List[Finding]:
    try:
        module = ModuleInfo(path, src=src, relpath=relpath)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=relpath or str(path),
                        line=e.lineno or 1, col=e.offset or 0,
                        func="<module>", message=f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in ALL_RULES:
        findings.extend(rule.check(module))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def run_lint(paths: Sequence, baseline_path=None) -> dict:
    """Lint ``paths`` and diff against the baseline. Returns a report
    dict (JSON-ready); ``report["ok"]`` is the pass/fail verdict."""
    all_findings: List[Finding] = []
    files = iter_py_files(paths)
    for abspath, rel in files:
        all_findings.extend(lint_file(abspath, relpath=rel))
    active = [f for f in all_findings if not f.suppressed
              and f.rule != "parse-error"]
    suppressed = [f for f in all_findings if f.suppressed]
    parse_errors = [f for f in all_findings if f.rule == "parse-error"]

    base = baseline_mod.load(baseline_path) if baseline_path else \
        {"version": baseline_mod.VERSION, "findings": []}
    new, grandfathered, stale = baseline_mod.diff(active, base)

    by_rule: Dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "files": len(files),
        "counts": {
            "active": len(active), "suppressed": len(suppressed),
            "new": len(new), "grandfathered": len(grandfathered),
            "stale_baseline": len(stale), "parse_errors": len(parse_errors),
        },
        "by_rule": by_rule,
        "new": [f.to_dict() for f in new],
        "grandfathered": [f.to_dict() for f in grandfathered],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_baseline": stale,
        "parse_errors": [f.to_dict() for f in parse_errors],
        "rule_titles": RULE_TITLES,
        "ok": not new and not parse_errors,
        "_findings": all_findings,      # stripped before JSON output
    }


def _render_text(report: dict, out) -> None:
    c = report["counts"]
    for f in report["parse_errors"]:
        print(f"{f['path']}:{f['line']}: {f['message']}", file=out)
    for f in report["new"]:
        print(f"{f['path']}:{f['line']}:{f['col']}: {f['rule']} "
              f"[{f['func']}] {f['message']}", file=out)
    for e in report["stale_baseline"]:
        print(f"stale baseline entry (fixed? re-baseline to shrink): "
              f"{e['rule']} {e['path']} [{e['func']}]", file=out)
    print(f"lint: {report['files']} files, {c['active']} active "
          f"({c['grandfathered']} grandfathered, {c['new']} new), "
          f"{c['suppressed']} suppressed host-ok, "
          f"{c['stale_baseline']} stale baseline entries", file=out)
    print("OK" if report["ok"] else "FAIL: new findings", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="host-sync lint of the PyTorch port")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline.json to grandfather findings against")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write a fresh baseline grandfathering the "
                         "current active findings, then exit 0")
    ns = ap.parse_args(argv)

    report = run_lint(ns.paths or ["src/repro_torch"],
                      baseline_path=ns.baseline)
    findings = report.pop("_findings")

    if ns.write_baseline:
        active = [f for f in findings
                  if not f.suppressed and f.rule != "parse-error"]
        baseline_mod.save(ns.write_baseline, active,
                          note="grandfathered findings; shrink, don't grow")
        print(f"wrote {len(active)} entries to {ns.write_baseline}")
        return 0

    if ns.format == "json":
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        _render_text(report, sys.stdout)
    if report["parse_errors"]:
        return 2
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
