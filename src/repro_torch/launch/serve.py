"""Serving launcher of the port: a batched synthetic request workload
through the IBEX paged-KV engine (``--serial`` runs the per-lane baseline).
Runs on the card unless ``--device`` names another; params are random,
from a seeded generator.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --reduced --requests 8 --new-tokens 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3_moe_235b_a22b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon_mamba_7b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch zamba2_2p7b --reduced --device cpu

Every arch id runs; the frontend backbones (chameleon_34b,
musicgen_medium) are fed zero embeddings, as the reference's engine feeds
them; falcon_mamba_7b's engine parks raw recurrent state, and
zamba2_2p7b's parks its Mamba2 state raw beside its compressed KV suffix
(for both, a prompt must be at most the scan chunk long or a multiple of
it: ROADMAP C10).

A config whose params do not fit in the device's memory (the published
qwen3-moe and arctic on one card) is refused before anything is
allocated.

``--trace OUT.trace.json`` attaches a ``repro_torch.obs.Recorder`` (its
samples ride the engine's one fetch a step: on the batched engine
``step_syncs == steps`` is asserted), writes the Perfetto ``trace_event``
timeline there and the metrics snapshot beside it
(``OUT.metrics.json``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --reduced --requests 5 --lanes 2 --device cpu --trace out.trace.json

``main`` returns the engine (its recorder is ``engine.obs``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.common.types import ServeConfig
from repro_torch.common.utils import resolve_device
from repro_torch.configs import describe, get_config, get_reduced
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs import Recorder
from repro_torch.obs import export as OBX
from repro_torch.serve import Engine, SerialEngine


def device_memory_bytes(dev: torch.device) -> int:
    """The card's memory, or the host's physical memory for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def main(argv=None) -> Engine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--vary-prompts", action="store_true",
                    help="mix prompt lengths (exercises length bucketing)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--kv-bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--serial", action="store_true",
                    help="per-lane baseline engine instead of the batched "
                         "scheduler")
    ap.add_argument("--paper-mode", action="store_true",
                    help="promote-then-read instead of fused dequant attn")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--trace", default=None, metavar="OUT.trace.json",
                    help="attach a repro_torch.obs.Recorder (samples ride "
                         "the engine's one fetch a step: zero extra syncs, "
                         "asserted), write the Perfetto trace_event export "
                         "there plus a .metrics.json sibling")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(describe(cfg))
    dev = resolve_device(args.device)
    need = cfg.param_count() * torch.finfo(L.torch_dtype(cfg)).bits // 8
    have = device_memory_bytes(dev)
    if need > have:
        raise SystemExit(f"{cfg.name}: {need} B of {cfg.dtype} params "
                         f"exceed the {have} B of {dev}")
    scfg = ServeConfig(max_running=args.lanes, hot_window=16, attn_chunk=32,
                       kv_rate_bits=args.kv_bits,
                       fused_dequant_attention=not args.paper_mode)
    params = T.init_params(cfg, seed=0, device=args.device)
    engine_cls = SerialEngine if args.serial else Engine
    rec = Recorder() if args.trace else None
    eng = engine_cls(cfg, scfg, params, max_len=args.max_len,
                     device=args.device, obs=rec)

    rng = np.random.default_rng(0)

    def plen(i):
        return (8 + 4 * (i % 5)) if args.vary_prompts else args.prompt_len

    rids = [eng.submit(list(rng.integers(1, cfg.vocab_size, plen(i))),
                       args.new_tokens) for i in range(args.requests)]
    t0 = time.time()
    eng.run_until_done(max_steps=5000)
    dt = time.time() - t0
    done = sum(eng.requests[r].state == "done" for r in rids)
    c = eng.counters
    print(f"served {done}/{len(rids)} requests, "
          f"{c['tokens']} tokens in {dt:.1f}s "
          f"({c['tokens'] / max(dt, 1e-9):.1f} tok/s) "
          f"[{'serial' if args.serial else 'batched'}, {eng.device}]")
    print(f"pool: promotions={c['promotions']} demotions={c['demotions']} "
          f"preempt_bytes={c['preempt_bytes']} "
          f"shadow_repreempts={c['shadow_repreempts']}")
    print(f"host: step_syncs={c['step_syncs']}/{c['steps']} steps, "
          f"admit_syncs={c['admit_syncs']}, "
          f"prefill_batches={c['prefill_batches']}")
    mt = eng.modeled_time()
    print(f"modeled: {mt['modeled_s'] * 1e3:.3f}ms total, "
          f"{mt['modeled_s_per_step'] * 1e6:.2f}us/step "
          f"(sync={mt['sync_s'] * 1e3:.3f}ms, motion bottleneck="
          f"{max(mt['motion_s_per_expander']) * 1e6:.2f}us)")
    if rec is not None:
        if not args.serial:   # the serial baseline syncs once a lane a step
            assert c["step_syncs"] == c["steps"], \
                "recording changed the per-step sync budget"
        mpath = OBX.metrics_path(args.trace)
        OBX.write_trace(rec, args.trace)
        OBX.write_metrics(rec, mpath)
        print(f"trace: {args.trace} (+ {mpath}); {len(rec.steps)} steps, "
              f"{len(rec.serve_events)} events recorded at zero extra syncs"
              f"{'' if args.serial else ' (asserted)'}")
    for rid in rids[:3]:
        print(f"  req {rid}: {eng.result(rid)}")
    return eng


if __name__ == "__main__":
    main()
