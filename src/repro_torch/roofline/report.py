"""The roofline table of the port's dry-run records (the reference's
``repro.roofline.report``), priced at the H100's roofs.

  PYTHONPATH=src python -m repro_torch.roofline.report \\
      [--dir results/dryrun_torch] [--pod d8]

The reference corrects XLA's FLOPs and bytes for a ``lax.scan`` body that
cost analysis counts once (``scan_trips``); the port's counts are of the
whole step already (``roofline/count.py``), so nothing here corrects them.
A row's ideal compute time is the model FLOPs over the ranks at
``analyze.PEAK_FLOPS``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.common.types import SHAPES_BY_NAME
from repro_torch.roofline.analyze import PEAK_FLOPS, analyze_record


def tokens_for(shape_name: str) -> int:
    s = SHAPES_BY_NAME[shape_name]
    if s.kind in ("train", "prefill"):
        return s.global_batch * s.seq_len
    return s.global_batch          # one decode step


def build_rows(results_dir: str, pod: Optional[str] = None) -> List[Dict]:
    """One row a record of ``results_dir`` (those whose cell ends in
    ``__<pod>`` or has it before a tag, when ``pod`` is given), with the
    record's own tokens (a record of a CLI recipe has its own sequence and
    batch)."""
    rows = []
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith(".json") or (
                pod and f"__{pod}." not in name and f"__{pod}__" not in name):
            continue
        with open(os.path.join(results_dir, name)) as f:
            rec = json.load(f)
        if rec.get("status") == "skipped":
            rows.append({"cell": rec["cell"], "skipped": True,
                         "reason": rec["reason"]})
            continue
        rl = analyze_record(rec, rec["tokens"], rec["kind"])
        chips = 1
        for s in rec["mesh"]:
            chips *= s
        ideal_compute_s = rl.model_flops / (chips * PEAK_FLOPS)
        bound = max(rl.compute_s, rl.memory_s, rl.collective_s, 1e-30)
        rows.append({
            "cell": rec["cell"], "arch": rec["arch"], "shape": rec["shape"],
            "skipped": False, "chips": chips,
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "model_flops": rl.model_flops, "hlo_flops": rl.hlo_flops,
            "useful_ratio": rl.useful_ratio,
            "bound_s": bound,
            # fraction of the peak-FLOP roofline the *useful* model math
            # achieves if the dominant term fully serializes the step
            "roofline_frac": ideal_compute_s / bound,
            "temp_gb": (rec["memory"]["temp_bytes"] or 0) / 1e9,
            "arg_gb": (rec["memory"]["argument_bytes"] or 0) / 1e9,
            "fits": rec["fits"], "count_s": rec.get("count_s"),
        })
    return rows


def fmt(v: float) -> str:
    if v == 0:
        return "0"
    if v < 1e-6:
        return f"{v * 1e9:.1f}n"
    if v < 1e-3:
        return f"{v * 1e6:.1f}u"
    if v < 1:
        return f"{v * 1e3:.2f}m"
    return f"{v:.2f}"


def markdown(rows: List[Dict]) -> str:
    out = ["| cell | compute | memory | collective | dominant | MODEL_FLOPs/HLO | roofline frac | mem/chip |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["skipped"]:
            out.append(f"| {r['cell']} | — | — | — | skipped | — | — | — |")
            continue
        out.append(
            f"| {r['cell']} | {fmt(r['compute_s'])}s | {fmt(r['memory_s'])}s "
            f"| {fmt(r['collective_s'])}s | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac']:.2%} "
            f"| {r['arg_gb'] + r['temp_gb']:.2f} GB |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--pod", default=None,
                    help="only cells of this mesh tag (pod1, pod2, dN)")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    rows = build_rows(args.dir, args.pod)
    print(markdown(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
