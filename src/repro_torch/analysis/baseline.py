"""Baseline ratchet of the port's host-sync lint (``repro.analysis.baseline``'s
format: version 1, the same fingerprints).

A committed ``baseline.json`` is the multiset of finding fingerprints
that existed when the analyzer was adopted (or last deliberately
re-baselined). The lint passes when the fresh run produces no finding
OUTSIDE that multiset — grandfathered debt is allowed, new debt fails.
Fingerprints are line-number-free (rule|path|func|message), so the
baseline survives unrelated edits; fixing a grandfathered finding makes
its entry *stale*, which the self-check test (and ``--format json``
output) reports so the baseline only ever shrinks.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Finding

VERSION = 1


def load(path) -> dict:
    data = json.loads(Path(path).read_text())
    if data.get("version") != VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return data


def save(path, findings: Sequence[Finding], note: str = "") -> dict:
    """Write a baseline grandfathering the *active* (unsuppressed)
    findings in ``findings``."""
    entries = [
        {"fingerprint": f.fingerprint(), "rule": f.rule, "path": f.path,
         "func": f.func, "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
        if not f.suppressed
    ]
    data = {"version": VERSION, "note": note, "findings": entries}
    Path(path).write_text(json.dumps(data, indent=2) + "\n")
    return data


def diff(active: Sequence[Finding],
         baseline: dict) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """(new, grandfathered, stale-entries). Multiset semantics: two
    identical findings need two baseline entries — a *second* instance
    of a grandfathered mistake still counts as new."""
    remaining: Dict[str, int] = Counter(
        e["fingerprint"] for e in baseline.get("findings", []))
    new: List[Finding] = []
    old: List[Finding] = []
    for f in active:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    stale_fps = {fp for fp, n in remaining.items() if n > 0}
    stale = [e for e in baseline.get("findings", [])
             if e["fingerprint"] in stale_fps]
    return new, old, stale
