"""How often a torch.profiler trace of decode steps loses kernel records,
on the card, and whether a lost record persists from one trace to the
next in one process.

It serves musicgen-medium at its published widths (48 layers; phase 15c
of ``chip_smoke.py``: 8 lanes, 4-bit KV, prompts 311-980 tokens) and takes
18 traces of ``PROFILE_STEPS`` decode steps after 1 warm-up step, then 18
after 2, each recording the card's activity only (``chip_smoke.py``'s
``_profile_steps``). For each trace it prints the device events, the B5
and ring-step records against the launches their counters saw, and for
each warm-up the number of traces that hold fewer records than ran.

    python3 tools/trace_loss.py        # needs a card and nvcc (~4 min)
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402

TRACES = 18


def main() -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.common.types import ServeConfig
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, smi = C.phase_device()
    C.phase_build(smi)
    cfg = C._musicgen()
    params = T.init_params(cfg, seed=C.SEED, device=dev)
    eng = Engine(cfg, ServeConfig(**C.SERVE_CFG), params,
                 max_len=C.SERVE_MAX_LEN)
    # every trace's steps with every lane running, and some to spare
    steps = 3 + TRACES * (2 * C.PROFILE_STEPS + 3) + 8
    for p in C._prompts(C.SERVE_CFG["max_running"], cfg.vocab_size,
                        C.SEED + 4):
        eng.submit(p, max_new_tokens=steps)
    for _ in range(3):                  # admission, prefill, warm steps
        eng.step()

    def trace(warmup: int) -> dict:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup,
                                       active=1)) as prof:
            for _ in range(warmup):
                eng.step()
                torch.cuda.synchronize()
                prof.step()
            b0, r0 = KA.launches, qpack.ring_step_launches
            for _ in range(C.PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            b1, r1 = KA.launches, qpack.ring_step_launches
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
        return {"events": len(ev),
                "b5": sum("kvc_split_kernel" in e.name for e in ev),
                "b5_ran": b1 - b0,
                "ring": sum("ring_step" in e.name for e in ev),
                "ring_ran": r1 - r0}

    t0 = time.perf_counter()
    for warmup in (1, 2):
        short = 0
        for i in range(TRACES):
            r = trace(warmup)
            short += r["b5"] != r["b5_ran"] or r["ring"] != r["ring_ran"]
            print(f"warmup {warmup} trace {i}: {r}", flush=True)
        print(f"warmup {warmup}: {short} of {TRACES} traces short",
              flush=True)
    print(f"done {time.perf_counter() - t0:.3f} s [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
