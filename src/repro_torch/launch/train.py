"""Training launcher of the port (the reference's ``repro.launch.train``):
--arch selectable, fault tolerant (a failed step is retried from the last
checkpoint), deterministic data replay. Runs on the card unless
``--device`` names another; params are random, from a seeded generator (so
the losses differ from the JAX launcher's, whose params come from JAX's
generator).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --reduced --steps 3 --seq-len 32 --global-batch 4 --compress-state \\
      --device cpu

A printed step reads its loss and grad norm from the card in one counted
sync; the step itself makes none. Checkpoints (every ``--ckpt-every``
steps, written by a worker thread) go to ``--ckpt-dir``, by default
``repro_torch_<arch>_ckpt`` in the temporary directory; a run resumes from
the newest valid one there. One device, as the reference's launcher (it
has no data-parallel flag; a GSPMD mesh is ROADMAP A.9).

``main`` returns {"params", "opt", "metrics" (step -> the step's metrics,
on the device), "start", "retries"}.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.common import contracts
from repro_torch.common.types import OptimizerConfig, TrainConfig
from repro_torch.common.utils import resolve_device
from repro_torch.configs import describe, get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-state", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(describe(cfg))
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_{args.arch}_ckpt"),
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                  compress_state=args.compress_state))

    params = trainer.init_params(cfg, tcfg.seed, dev)
    opt = adamw.init(params, tcfg.optimizer)
    step_fn, _ = trainer.make_train_step(cfg, tcfg)

    def restore(step: int):
        tree, _ = ckpt.restore(tcfg.checkpoint_dir, step,
                               {"params": params, "opt": opt})
        return tree["params"], tree["opt"]

    start = ckpt.latest(tcfg.checkpoint_dir)
    if start is not None:
        params, opt = restore(start)
        print(f"resumed from step {start}")
    start = start or 0

    metrics_by_step = {}
    retries = 0
    step = start
    t0 = time.time()
    while step < tcfg.steps:
        try:
            batch = make_batch(cfg, step, global_batch=tcfg.global_batch,
                               seq_len=tcfg.seq_len, device=dev)
            params, opt, metrics = step_fn(params, opt, batch)
            metrics_by_step[step] = metrics
            if step % 10 == 0 or step == tcfg.steps - 1:
                host = contracts.fetch({k: metrics[k]
                                        for k in ("loss", "grad_norm")})
                dt = (time.time() - t0) / max(step - start + 1, 1)
                print(f"step {step:4d}  loss={float(host['loss']):.4f}  "
                      f"gnorm={float(host['grad_norm']):.3f}  "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
            if (step + 1) % tcfg.checkpoint_every == 0:
                ckpt.save_async(tcfg.checkpoint_dir, step + 1,
                                {"params": params, "opt": opt},
                                keep=tcfg.keep_checkpoints)
            step += 1
        except Exception as e:   # step-level retry from the last checkpoint
            retries += 1
            if retries > args.max_retries:
                raise
            print(f"step {step} failed ({e}); retrying from last checkpoint")
            ckpt.wait_pending()
            latest = ckpt.latest(tcfg.checkpoint_dir)
            if latest is not None:
                params, opt = restore(latest)
                step = latest
    ckpt.wait_pending()
    print("training complete")
    return {"params": params, "opt": opt, "metrics": metrics_by_step,
            "start": start, "retries": retries}


if __name__ == "__main__":
    main()
