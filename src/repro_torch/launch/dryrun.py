"""Dry run of the port: what every (arch x shape x mesh) cell costs one rank,
counted without a card or an allocation (the reference's
``repro.launch.dryrun``, as far as an H100 has a counterpart).

The reference lowers and compiles each cell's step on 512 forced host
devices and reads XLA's memory and cost analyses and the collectives of
the post-SPMD HLO. The port has no HLO. Here each cell's leaves are made on
the meta device (shapes and types, nothing allocated), each leaf is this
rank's block of its spec under the port's rule tables
(``launch/mesh.py::rules_for``, ``common/sharding.py::logical_to_spec``)
and the step's work is counted from the model config
(``roofline/count.py``): executed matmul FLOPs and the rest, a floor of
HBM bytes, the collectives as the port's ``Mesh`` moves them, and the
rank's memory. The optimizer state follows the port's layout: raw moments
as their params, compressed moments whole on every rank
(``train/trainer.py::mesh_shardings``). A dim that does not split evenly
over its mesh axes fails the cell, as the reference's sharded arguments
do.

Each record holds the reference's fields (``flops``: executed matmul
FLOPs a rank; ``bytes_accessed``: the HBM floor; ``collective_bytes``;
``memory.{argument,output,temp}_bytes``; ``params``; ``active_params``),
the rank's bytes by kind (``per_rank``), ``flops_f32`` (the part of
``flops`` that runs in float32), ``other_flops``, ``model_flops`` and
``fits``: the peak estimate (``peak_bytes``) against the memory a process
can have of the card (``roofline.analyze.HBM_BYTES``). ``temp_bytes`` is that estimated peak
less the arguments: the grads, the outputs and an estimate of the step's
working set (``count.train_memory``/``serve_memory``); the argument bytes
are exact. Serve cells carry no collectives (the port
serves on one device); every family's train cell carries its mesh step's
(``count.train_collectives``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
      --shape train_4k --devices 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --devices 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # (16, 16)
                                                             # and (2, 16, 16)
  # the one-card train recipe (TRAIN_512)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \
      --shape train_512 --devices 1
Records go to ``results/dryrun_torch/<cell>.json``; a cell is
``<arch>__<shape>__<pod1|pod2|dN>`` (and ``__<tag>``).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common import sharding as SH
from repro_torch.common import tree as TR
from repro_torch.common.types import (ALL_SHAPES, SHAPES_BY_NAME, MeshConfig,
                                      ModelConfig, OptimizerConfig,
                                      ServeConfig, ShapeConfig, TrainConfig)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as M
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.roofline import analyze
from repro_torch.roofline import count as C
from repro_torch.train import elastic, trainer

RESULTS_DIR = "results/dryrun_torch"
META = torch.device("meta")

# variant knobs (set by the CLI; defaults = the reference's baseline)
VARIANT = {
    "paper_mode": False,        # serve: promote-then-read vs fused dequant
    "microbatches": None,       # train: override grad-accum microbatches
    "serve_replicate_params": False,  # decode/prefill: fsdp -> replicated
    "kv_bits": 4,
    "tag": "",
}

# the port's one-card train recipe: TrainConfig's sequence and batch, one
# microbatch, the compressed state (``launch/train.py --compress-state``,
# chip_smoke.py phase 18b); counted by name (``--shape train_512``), not
# one of ``--all``'s shapes
TRAIN_512 = ShapeConfig("train_512", TrainConfig.seq_len,
                        TrainConfig.global_batch, "train")
CELL_SHAPES = {**SHAPES_BY_NAME, TRAIN_512.name: TRAIN_512}


# ---------------------------------------------------------------------------
# input_specs: meta tensors standing in for every input of the cell's step.
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
             "labels": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.frontend != "none":
        specs["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    return specs


def serve_cfg_for(cfg: ModelConfig, shape: ShapeConfig) -> ServeConfig:
    # chunk must divide the per-shard sequence (long: 524288/32 = 16384)
    chunk = 2048
    return ServeConfig(hot_window=256, attn_chunk=chunk,
                       kv_rate_bits=VARIANT["kv_bits"],
                       fused_dequant_attention=not VARIANT["paper_mode"])


@functools.lru_cache(maxsize=None)
def abstract_params(cfg: ModelConfig):
    """(params on the meta device in the trainer's stacked layout, their
    logical-axes tree): nothing allocated (one tree a config, kept)."""
    return trainer.init_params(cfg, 0, META), T.param_axes(cfg)


def abstract_opt(params, ocfg: OptimizerConfig) -> adamw.AdamState:
    """``adamw.init``'s state on the meta device: raw moments as their
    params in ``moment_dtype``, or a compressed leaf's codes (uint8),
    scales (f32) and block (a host int)."""
    step = torch.empty((), dtype=torch.int32, device=META)
    if not ocfg.compress_state:
        mdt = adamw.MOMENT_DTYPES[ocfg.moment_dtype]

        def moment(p):
            return torch.empty(p.shape, dtype=mdt, device=META)
        return adamw.AdamState(step, TR.map_tree(moment, params),
                               TR.map_tree(moment, params))

    def comp(p):
        n = p.numel()
        b = adamw._blk(n, ocfg.state_block)
        return {"codes": torch.empty((n,), dtype=torch.uint8, device=META),
                "scales": torch.empty((n // b,), dtype=torch.float32,
                                      device=META), "block": b}
    return adamw.AdamState(step, TR.map_tree(comp, params),
                           TR.map_tree(comp, params))


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Meta tensors for the inputs of this cell's step (no allocation)."""
    params = abstract_params(cfg)[0]
    if shape.kind == "train":
        tcfg = tcfg or train_cfg_for(cfg, shape)
        return {"params": params, "opt": abstract_opt(params,
                                                      tcfg.optimizer),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        batch.pop("labels")
        return {"params": params, "batch": batch}
    scfg = serve_cfg_for(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    specs = {"params": params,
             "cache": D.init_cache(cfg, scfg, B, S, META),
             "tokens": torch.empty((B,), dtype=torch.int32, device=META),
             "pos": torch.empty((B,), dtype=torch.int32, device=META)}
    if cfg.frontend != "none":
        specs["embeds"] = torch.empty((B, cfg.d_model), dtype=torch.bfloat16,
                                      device=META)
    return specs


def train_cfg_for(cfg: ModelConfig, shape: ShapeConfig) -> TrainConfig:
    # big models: bf16 moments (the reference's choice for a v5e's 16 GB)
    big = cfg.param_count() > 3e10
    mb = VARIANT["microbatches"]
    recipe = shape.name == TRAIN_512.name
    return TrainConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        microbatches=(mb if mb else 1 if recipe else 8)
        if shape.kind == "train" else 1,
        optimizer=OptimizerConfig(
            moment_dtype="bfloat16" if big else "float32",
            compress_state=recipe))


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (DESIGN.md skip)")
    return True, ""


# ---------------------------------------------------------------------------
# The count of one cell.
# ---------------------------------------------------------------------------

def _maybe_replicate_serve(rules):
    if not VARIANT["serve_replicate_params"]:
        return rules
    d = dict(rules)
    d["fsdp"] = None
    return tuple(d.items())


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
               tcfg: Optional[TrainConfig] = None,
               scfg: Optional[ServeConfig] = None,
               route: str = "kernel") -> Dict[str, Any]:
    """The record's counts for ``cfg`` at ``shape`` on ``mesh`` (one rank;
    ``route``: B6's, "kernel" on the card, "plain" on the CPU)."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    model = sizes.get("model", 1)
    rules = M.rules_for(shape, mesh.axes, cfg, model)
    if shape.kind != "train":
        rules = _maybe_replicate_serve(rules)
    chips = mesh.num_devices
    params, axes = abstract_params(cfg)
    specs = SH.tree_specs(axes, rules, mesh.axes)
    pblocks = C.blocks(params, specs, mesh.shape, mesh.axes)
    p_bytes = C.total_bytes(pblocks)
    values = sum(b.numel for b in pblocks)
    rows_spec = SH.logical_to_spec(("batch", "seq"), rules, mesh.axes)
    B, S = shape.global_batch, shape.seq_len
    rows = SH.block_shape((B, S), rows_spec, sizes)[0]
    rec: Dict[str, Any] = {"mesh": list(mesh.shape), "axes": list(mesh.axes),
                           "kind": shape.kind, "seq_len": S,
                           "global_batch": B, "route": route}
    if shape.kind == "train":
        tcfg = tcfg or train_cfg_for(cfg, shape)
        sh = trainer.mesh_shardings(cfg, tcfg.optimizer, mesh, specs, rules)
        opt = abstract_opt(params, tcfg.optimizer)
        state_b = C.total_bytes(C.blocks(opt, sh["opt"].specs, mesh.shape,
                                         mesh.axes))
        batch_b = C.total_bytes(C.blocks(batch_specs(cfg, shape),
                                         sh["batch"].specs, mesh.shape,
                                         mesh.axes))
        k = max(tcfg.microbatches, 1)
        if rows % k:
            raise ValueError(f"{rows} rows a rank do not split into {k} "
                             "microbatches")
        mm = k * C.train_matmul_flops(cfg, B // k, S, route)
        mm32 = k * C.train_matmul_flops(cfg, B // k, S, route, f32=True)
        other = C.other_flops(cfg, B, S, "train")
        mem = C.train_memory(cfg, tcfg, pblocks, state_b, batch_b, rows,
                             sizes)
        rec["bytes_accessed"] = C.train_hbm_floor(cfg, tcfg, pblocks,
                                                  state_b, rows, sizes)
        rec["collective_bytes"] = C.train_collectives(
            cfg, tcfg, pblocks, mesh.shape, mesh.axes, rows_spec)
        arg = p_bytes + state_b + batch_b
        rec["memory"] = {"argument_bytes": arg,
                         "output_bytes": p_bytes + state_b + 12,
                         "temp_bytes": mem["peak"] - arg,
                         "generated_code_bytes": None}
        rec["per_rank"] = dict(mem, values=values)
        rec["microbatches"] = k
        rec["compress_state"] = tcfg.optimizer.compress_state
        tokens = B * S
    else:
        scfg = scfg or serve_cfg_for(cfg, shape)
        if shape.kind == "prefill":
            batch = input_specs(cfg, shape)["batch"]
            inputs = C.total_bytes(C.blocks(
                batch, {"tokens": rows_spec, "embeds": SH.logical_to_spec(
                    ("batch", "seq", "embed"), rules, mesh.axes)},
                mesh.shape, mesh.axes))
            cache = C.total_bytes(C.blocks(
                D.init_cache(cfg, scfg, B, S, META),
                SH.tree_specs(D.leaf_axes(cfg, scfg), rules, mesh.axes),
                mesh.shape, mesh.axes))
            mm = C.prefill_matmul_flops(cfg, B, S, route)
            mm32 = C.prefill_matmul_flops(cfg, B, S, route, f32=True)
            tokens = B * S
        else:
            cache_t = D.init_cache(cfg, scfg, B, S, META)
            cache = C.total_bytes(C.blocks(
                cache_t, SH.tree_specs(D.leaf_axes(cfg, scfg), rules,
                                       mesh.axes), mesh.shape, mesh.axes))
            tok_spec = SH.logical_to_spec(("batch",), rules, mesh.axes)
            inputs = 2 * C.total_bytes(C.blocks(
                torch.empty((B,), dtype=torch.int32, device=META), tok_spec,
                mesh.shape, mesh.axes))
            if cfg.frontend != "none":
                inputs += C.total_bytes(C.blocks(
                    torch.empty((B, cfg.d_model), dtype=torch.bfloat16,
                                device=META),
                    SH.logical_to_spec(("batch", "embed"), rules, mesh.axes),
                    mesh.shape, mesh.axes))
            mm = C.decode_matmul_flops(cfg, B, S)
            mm32 = C.decode_matmul_flops(cfg, B, S, f32=True)
            tokens = B
        other = C.other_flops(cfg, B, S, shape.kind)
        srows = SH.block_shape((B,), SH.logical_to_spec(
            ("batch",), rules, mesh.axes), sizes)[0]
        mem = C.serve_memory(cfg, shape.kind, srows, S, p_bytes, cache,
                             inputs, scfg)
        arg = p_bytes + inputs + (cache if shape.kind == "decode" else 0)
        rec["bytes_accessed"] = C.serve_hbm_floor(
            cfg, shape.kind, srows, S, C.gathered_bytes(pblocks, sizes),
            cache, mem["logits"])
        rec["collective_bytes"] = None
        rec["collective_reason"] = C.SERVE_REASON
        rec["memory"] = {"argument_bytes": arg,
                         "output_bytes": mem["logits"] + cache,
                         "temp_bytes": mem["peak"] - arg,
                         "generated_code_bytes": None}
        rec["per_rank"] = mem
    rec["flops"] = mm / chips
    rec["flops_f32"] = mm32 / chips
    rec["other_flops"] = other / chips
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    rec["tokens"] = tokens
    rec["model_flops"] = analyze.model_flops(rec["params"],
                                             rec["active_params"], tokens,
                                             shape.kind)
    rec["peak_bytes"] = rec["per_rank"]["peak"]
    rec["device_memory"] = analyze.HBM_BYTES
    rec["fits"] = bool(rec["peak_bytes"] <= analyze.HBM_BYTES)
    return rec


def mesh_for(multi_pod: bool, devices: Optional[int]) -> Tuple[MeshConfig,
                                                               str]:
    """(the cell's mesh, its tag): ``plan_mesh(devices, prefer_model=2)``
    as ``--devices`` plans it, else the reference's production meshes."""
    if devices:
        return elastic.plan_mesh(devices, prefer_model=2), f"d{devices}"
    if multi_pod:
        return MeshConfig((2, 16, 16), ("pod", "data", "model")), "pod2"
    return MeshConfig((16, 16), ("data", "model")), "pod1"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, devices: Optional[int] = None
             ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = CELL_SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    mesh, mtag = mesh_for(multi_pod, devices)
    cell = f"{arch}__{shape_name}__{mtag}" + \
        (f"__{VARIANT['tag']}" if VARIANT["tag"] else "")
    if not ok:
        rec = {"cell": cell, "status": "skipped", "reason": why}
        _write(out_dir, cell, rec)
        return rec
    t0 = time.perf_counter()
    rec = {"cell": cell, "status": "ok", "arch": arch, "shape": shape_name,
           **count_cell(cfg, shape, mesh)}
    rec["count_s"] = round(time.perf_counter() - t0, 3)
    _write(out_dir, cell, rec)
    return rec


def _write(out_dir: str, cell: str, rec: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(CELL_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="count on plan_mesh(N, prefer_model=2) instead of "
                         "the production meshes")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--paper-mode", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--serve-replicate-params", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=4)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    VARIANT.update(paper_mode=args.paper_mode,
                   microbatches=args.microbatches or None,
                   serve_replicate_params=args.serve_replicate_params,
                   kv_bits=args.kv_bits, tag=args.tag)

    pods = []
    if args.devices:
        pods = [False]
    else:
        if args.multi_pod or not args.single_pod:
            pods.append(True)
        if args.single_pod or not args.multi_pod:
            pods.insert(0, False)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    failures, cells, t0 = 0, 0, time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                cells += 1
                try:
                    rec = run_cell(arch, shape, mp, args.out,
                                   args.devices or None)
                    status = rec["status"]
                    extra = "" if status != "ok" else (
                        f" flops={rec['flops']:.3g} peak="
                        f"{rec['peak_bytes'] / 2 ** 30:.2f}GiB "
                        f"fits={rec['fits']} count={rec['count_s']}s")
                    print(f"[{status:7s}] {rec['cell']}{extra}", flush=True)
                except Exception as e:
                    failures += 1
                    tag = f"d{args.devices}" if args.devices else \
                        ("pod2" if mp else "pod1")
                    print(f"[FAIL   ] {arch}__{shape}__{tag}: {e}",
                          flush=True)
                    traceback.print_exc()
    print(f"dryrun: {failures} failures, {cells} cells in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
