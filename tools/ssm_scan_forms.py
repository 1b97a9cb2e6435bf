"""The SSM scan's two routes on the card: a mixer's prefill without
autograd (``models/ssm.py``'s ``out=`` passes, serving's route) against
its forward under autograd (training's ``_ScanChunk``, the same passes
with only the chunk's inputs saved), and that forward with its backward,
at falcon-mamba-7b's (Mamba1) and zamba2-2.7b's (Mamba2) widths.

Per (arch, batch) the routes run in turns serve, train, train, serve; a
turn is a warm-up call and 5 timed calls (CUDA events), the turn's median
kept; the backward is timed after each train turn. The outputs of the two
routes are compared bit for bit. Prints one JSON line a case and the
card's name and power limit.

    python3 tools/ssm_scan_forms.py                  # needs a card (~1 min)
    python3 tools/ssm_scan_forms.py --device cpu --batch 1 --seq 256
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

MIXERS = {"falcon_mamba_7b": (ssm.mamba1_init, ssm.mamba1_prefill),
          "zamba2_2p7b": (ssm.mamba2_init, ssm.mamba2_prefill)}


def _time(fn, dev, reps: int = 5) -> float:
    """Median ms of ``reps`` calls after a warm-up."""
    fn()
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def run(dev, batches, seq: int) -> list:
    rows = []
    for arch, (init, prefill) in MIXERS.items():
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = init(gen, cfg, torch.bfloat16, dev)
        for t in p.values():
            t.requires_grad_()
        for batch in batches:
            u = torch.randn((batch, seq, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            g = torch.randn_like(u)

            def serve():
                with torch.no_grad():
                    return prefill(p, u, cfg)

            def train():
                return prefill(p, u, cfg)

            def train_backward():
                train()[0].backward(g)

            outs, ms = {}, {"serve": [], "train": [], "backward": []}
            for form in ("serve", "train", "train", "serve"):
                fn = serve if form == "serve" else train
                outs[form] = fn()
                ms[form].append(_time(fn, dev))
                if form == "train":
                    ms["backward"].append(_time(train_backward, dev))
            equal = all(torch.equal(a.detach(), b) for a, b in zip(
                (outs["train"][0], *outs["train"][1]),
                (outs["serve"][0], *outs["serve"][1])))
            rows.append({"arch": arch, "batch": batch, "seq": seq,
                         "ms_serve": ms["serve"], "ms_train": ms["train"],
                         "ms_train_forward_backward": ms["backward"],
                         "train_over_serve": statistics.mean(ms["train"]) /
                         statistics.mean(ms["serve"]),
                         "bitwise_equal": equal})
            print(json.dumps(rows[-1]), flush=True)
            del u, g, outs
        del p
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rows = run(dev, args.batch, args.seq)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0 if all(r["bitwise_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
