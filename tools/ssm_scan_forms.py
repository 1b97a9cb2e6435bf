"""The SSM scan's two forms on the card: ``models/ssm.py::_scan_into``
(each Hillis-Steele pass written into the other of two buffers, serving's
form) against ``_scan_new`` (each pass new tensors, the form autograd can
differentiate), in one mixer's prefill at falcon-mamba-7b's (Mamba1) and
zamba2-2.7b's (Mamba2) widths, without autograd.

Per (arch, batch) the forms run in turns into, new, new, into; a turn is a
warm-up call and 5 timed calls (CUDA events), the turn's median kept. The
outputs of the two forms are compared bit for bit. Prints one JSON line a
case and the card's name and power limit.

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

FORMS = {"into": ssm._scan_into, "new": ssm._scan_new}
MIXERS = {"falcon_mamba_7b": (ssm.mamba1_init, ssm.mamba1_prefill),
          "zamba2_2p7b": (ssm.mamba2_init, ssm.mamba2_prefill)}
_dispatch = ssm._scan_chunk


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
        for batch in batches:
            u = torch.randn((batch, seq, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            outs, ms = {}, {k: [] for k in FORMS}
            with torch.no_grad():
                for form in ("into", "new", "new", "into"):
                    ssm._scan_chunk = FORMS[form]
                    outs[form] = prefill(p, u, cfg)
                    ms[form].append(_time(lambda: prefill(p, u, cfg), dev))
            ssm._scan_chunk = _dispatch
            equal = all(torch.equal(a, b) for a, b in zip(
                (outs["into"][0], *outs["into"][1]),
                (outs["new"][0], *outs["new"][1])))
            rows.append({"arch": arch, "batch": batch, "seq": seq,
                         "ms_into": ms["into"], "ms_new": ms["new"],
                         "new_over_into": statistics.mean(ms["new"]) /
                         statistics.mean(ms["into"]),
                         "bitwise_equal": equal})
            print(json.dumps(rows[-1]), flush=True)
            del u, outs
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
