#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic mix,
limits and metric readers are found by the names in ``BENCHMARK.json``.
Needs a CUDA card (as many as the cell asks for): without one it exits 2
and prints no result. The last line of standard output is the result's
JSON object; each number the check compared is printed beside its limit as
the last lines of standard error too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache of the program inside the checkout, at
    # fixed paths (the port's nvcc cache is build/repro_torch/ already)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    from bench.harness import cell, spec
    proc_start = cell.process_start_time()
    bench = spec.benchmark(ROOT)
    wl = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    ctx = cell.context(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0), proc_start,
                       bench=bench)
    line = cell.run(ctx, bench)
    bad = cell.forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    for name, h in line["checks"].items():
        print(f"check {name}: {h['value']!r} (limit {h['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
