"""Training launcher of the port (the reference's ``repro.launch.train``):
--arch selectable, fault tolerant (a failed step is retried from the last
checkpoint), deterministic data replay. Runs on the card unless
``--device`` names another; params are random, from a seeded generator (so
the losses differ from the JAX launcher's, whose params come from JAX's
generator).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --reduced --steps 3 --seq-len 32 --global-batch 4 --compress-state \\
      --device cpu

Every family trains: dense (GQA/MHA and MLA, minicpm3_4b), MoE
(qwen3_moe_235b_a22b, arctic_480b; the load-balance loss in the loss),
SSM (falcon_mamba_7b) and hybrid (zamba2_2p7b). On one device a model
whose step the dry run's count (``launch/dryrun.py::count_cell``), with
``COUNT_MARGIN`` added, puts past the device's memory is refused before
anything is allocated, both byte counts named (the published qwen3-moe
and arctic on one card).

A printed step reads its loss and grad norm from the card in one counted
sync; the step itself makes none. Checkpoints (every ``--ckpt-every``
steps, written by a worker thread) go to ``--ckpt-dir``, by default
``repro_torch_<arch>_ckpt`` in the temporary directory; a run resumes from
the newest valid one there.

``--devices D`` (D > 1) trains on the mesh the reference's launcher plans
from its device count, ``elastic.plan_mesh(D, prefer_model=2)`` ((data,
model) = (1, 2) at 2 ranks, (2, 2) at 4), through
``trainer.make_train_step(mesh=)`` on D ranks that the launcher spawns
itself (``common.sharding.spawn_ranks``): NCCL on the cards ``cuda:0..D-1``
(fewer visible cards raises), gloo with ``--device cpu``. Every rank makes
the seeded params and the global batch and keeps its blocks and rows;
checkpoints are written whole by rank 0 (``checkpoint.save(shardings=)``)
and restore onto any mesh. A failed step on a mesh is not retried: the
ranks would leave their collectives out of step, so the failure stops
every rank and raises. Rank 0 prints the mesh as the reference does.

``main`` returns {"params", "opt", "metrics" (step -> the step's metrics,
on the device), "start", "retries"}; with ``--devices D > 1``, rank 0's
{"mesh", "losses" (step -> loss), "start"}.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.common import contracts
from repro_torch.common import sharding as SH
from repro_torch.common.types import (MeshConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.common.utils import resolve_device
from repro_torch.configs import describe, get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import device_memory_bytes
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic, trainer

# seconds the spawned ranks of --devices may train before every rank is
# stopped (a rank stuck in a collective)
RANK_TIMEOUT = 86400.0
# the share the measured peak of a train step may exceed the dry run's
# count by: the count reads low for the SSM and hybrid families (on an
# H100, zamba2-2.7b's train_512 step peaked 8.4% above it and
# falcon-mamba-7b's 3.3%; minicpm3-4b's 0.6%)
COUNT_MARGIN = 0.10


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--devices", type=int, default=1, metavar="D",
                    help="D > 1: the mesh plan_mesh(D, prefer_model=2) on "
                         "D spawned ranks (NCCL on cuda:0..D-1; gloo with "
                         "--device cpu)")
    return ap


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.devices <= 1:
        return _train(args, resolve_device(args.device))
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    if not on_cpu:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards < args.devices:
            raise RuntimeError(f"--devices {args.devices} needs "
                               f"{args.devices} CUDA devices; {n_cards} "
                               f"visible (--device cpu runs gloo ranks)")
    return SH.spawn_ranks(_rank_main, args.devices,
                          backend="gloo" if on_cpu else "nccl",
                          args=(argv,), device="cpu" if on_cpu else None,
                          timeout=RANK_TIMEOUT)[0]


def _rank_main(group: SH.ExpanderGroup, argv) -> dict:
    """One rank of ``--devices D``."""
    return _train(_parser().parse_args(argv), group.device, group)


def check_fits(cfg, tcfg: TrainConfig, dev: torch.device) -> int:
    """The dry run's count of one train step's peak bytes on ``dev``
    alone; ``SystemExit`` naming it and the device's bytes
    (``device_memory_bytes``) where the count and ``COUNT_MARGIN`` of it
    pass them. The count is an estimate that reads low, so the margin
    refuses a step the count puts just under the device."""
    rec = dryrun.count_cell(
        cfg, ShapeConfig("launch", tcfg.seq_len, tcfg.global_batch,
                         "train"), MeshConfig((1, 1), ("data", "model")),
        tcfg, route="kernel" if dev.type == "cuda" else "plain")
    need, have = rec["peak_bytes"], device_memory_bytes(dev)
    if need * (1 + COUNT_MARGIN) > have:
        raise SystemExit(
            f"{cfg.name}: a train step of {tcfg.global_batch} x "
            f"{tcfg.seq_len} tokens needs {need} B by the dry run's count "
            f"(and {COUNT_MARGIN:.0%} more for what it misses), past the "
            f"{have} B of {dev}")
    return need


def _train(args, dev: torch.device, group: SH.ExpanderGroup = None):
    """The launcher's run on ``dev``: alone, or as one rank of the mesh
    (rank 0 prints and returns the summary; None on the others)."""
    rank = 0 if group is None else group.rank

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    say(describe(cfg))
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_{args.arch}_ckpt"),
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                  compress_state=args.compress_state))

    if group is None:
        check_fits(cfg, tcfg, dev)
    params = trainer.init_params(cfg, tcfg.seed, dev)
    mesh = shardings = both = None
    if group is not None:
        mesh = make_mesh(elastic.plan_mesh(group.world, prefer_model=2),
                         group)
        say(f"mesh: {dict(zip(mesh.axes, mesh.shape))}")
    step_fn, shardings = trainer.make_train_step(cfg, tcfg, mesh)
    if shardings is not None:
        params = shardings["params"].shard(params)
        both = SH.TreeSharding.join({"params": shardings["params"],
                                     "opt": shardings["opt"]})
    opt = adamw.init(params, tcfg.optimizer,
                     sharding=shardings and shardings["params"])

    def restore(step: int):
        tree, _ = ckpt.restore(tcfg.checkpoint_dir, step,
                               {"params": params, "opt": opt},
                               shardings=both)
        return tree["params"], tree["opt"]

    start = ckpt.latest(tcfg.checkpoint_dir)
    if start is not None:
        params, opt = restore(start)
        say(f"resumed from step {start}")
    start = start or 0

    metrics_by_step = {}
    retries = 0
    step = start
    t0 = time.time()
    while step < tcfg.steps:
        try:
            batch = make_batch(cfg, step, global_batch=tcfg.global_batch,
                               seq_len=tcfg.seq_len, device=dev)
            if shardings is not None:
                batch = shardings["batch"].shard(batch)
            params, opt, metrics = step_fn(params, opt, batch)
            metrics_by_step[step] = metrics
            if rank == 0 and (step % 10 == 0 or step == tcfg.steps - 1):
                host = contracts.fetch({k: metrics[k]
                                        for k in ("loss", "grad_norm")})
                dt = (time.time() - t0) / max(step - start + 1, 1)
                print(f"step {step:4d}  loss={float(host['loss']):.4f}  "
                      f"gnorm={float(host['grad_norm']):.3f}  "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
            if (step + 1) % tcfg.checkpoint_every == 0:
                if both is None:
                    ckpt.save_async(tcfg.checkpoint_dir, step + 1,
                                    {"params": params, "opt": opt},
                                    keep=tcfg.keep_checkpoints)
                else:
                    ckpt.save(tcfg.checkpoint_dir, step + 1,
                              {"params": params, "opt": opt},
                              keep=tcfg.keep_checkpoints, shardings=both)
            step += 1
        except Exception as e:   # step-level retry from the last checkpoint
            retries += 1
            if mesh is not None or retries > args.max_retries:
                raise
            print(f"step {step} failed ({e}); retrying from last checkpoint")
            ckpt.wait_pending()
            latest = ckpt.latest(tcfg.checkpoint_dir)
            if latest is not None:
                params, opt = restore(latest)
                step = latest
    ckpt.wait_pending()
    say("training complete")
    if group is None:
        return {"params": params, "opt": opt, "metrics": metrics_by_step,
                "start": start, "retries": retries}
    losses = contracts.fetch({str(s): m["loss"]
                              for s, m in metrics_by_step.items()})
    if rank:
        return None
    return {"mesh": dict(zip(mesh.axes, mesh.shape)), "start": start,
            "losses": {int(s): float(v) for s, v in losses.items()}}


if __name__ == "__main__":
    main()
