#!/usr/bin/env python3
"""Run several runs of ``bench/run.py`` one after another, each in a
process of its own, and keep each run's result line and the end of its
standard error.

    python3 bench/sweep.py --out runs/sets.jsonl \
        deepseek-7b.serve.oversub:101:30:0 deepseek-7b.serve.oversub:102:30:0

A run is ``workload:seed:seconds:trace``; ``--root DIR`` runs it from
another checkout (a parent's, to compare two trees in one call: parent,
change, change, parent). Every record (one JSON line a run) names the
card and its power limit. It is a tool for measuring the benchmark, not
a part of a run: a benchmark run never calls it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def one(spec: str, root: Path, timeout: float) -> dict:
    wl, seed, secs, trace = spec.split(":")
    cmd = [sys.executable, "bench/run.py", "--workload", wl, "--seed", seed,
           "--seconds", secs, "--trace", trace]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [ln for ln in out.splitlines() if ln.strip()]
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"run": spec, "root": str(root), "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr_tail": err[-6000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    c = card()
    print(f"card: {c}", flush=True)
    with open(out, "a") as f:
        for spec in args.runs:
            rec = one(spec, Path(args.root), args.timeout)
            rec["card"] = c
            f.write(json.dumps(rec) + "\n")
            f.flush()
            r = rec["result"] or {}
            m = {k: v["value"] for k, v in r.get("metrics", {}).items()}
            chk = {k: v["value"] for k, v in r.get("checks", {}).items()}
            print(f"{spec} rc={rec['rc']} wall={rec['wall_s']:.1f} "
                  f"correct={r.get('correct')} metrics={m} checks={chk} "
                  f"peak={r.get('device', {}).get('memory_peak_bytes')}",
                  flush=True)
            if rec["rc"] != 0 or not r:
                print(rec["stderr_tail"][-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
