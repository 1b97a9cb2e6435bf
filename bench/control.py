#!/usr/bin/env python3
"""Readings the limits are set from, several seeds in one process: each
seed runs the cell (a short window), then its check with the control (the
reference put in the program's place one precision below the
configuration's: float8 e4m3 linear layers for bf16) and, for a train
cell, the fault of half the batch left out, planted in the reference put
in the program's place. Each record holds the program's ``correct``,
every reading (held or not), and each variant's readings held against the
cell's limits with its own ``correct``, which must come out false.

    python3 bench/control.py --workload deepseek-7b.serve.oversub \
        --seconds 5 --out runs/control.jsonl 11 12 13

A tool for setting the limits: the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings only")
    ap.add_argument("--warm-steps", type=int, default=None,
                    help="a serve mix's set-up steps, in place of its own "
                         "(to read where the warm-up settles)")
    ap.add_argument("seeds", nargs="+", type=int)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from bench.harness import cell
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = cell.context(args.workload, seed, args.seconds, False,
                           torch.device("cuda", 0), time.time(),
                           control=not args.no_control)
        if args.warm_steps is not None:
            ctx.mix = dict(ctx.mix, warm_steps=args.warm_steps)
        line = cell.run(ctx)
        rec = {"workload": args.workload, "seed": seed,
               "correct": line["correct"],
               "checks": {k: v["value"] for k, v in line["checks"].items()},
               "readings": line.get("readings"),
               "variants": line.get("variants"),
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "wall_s": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        del ctx, line
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
