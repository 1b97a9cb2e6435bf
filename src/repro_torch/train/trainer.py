"""Train-step factory (the reference's ``repro.train.trainer``):
microbatched gradient accumulation, per-layer rematerialisation, AdamW with
the optionally compressed state.

The trainer keeps params, grads and moments in the reference's stacked
layout (``params["layers"]`` a dict of leaves stacked [L, ...]; the hybrid's
[G, period, ...] and its shared blocks [n, ...]), so the optimizer's block
rule sees the reference's leaves and a checkpoint has the reference's keys.
The model takes per-layer dicts (``models/transformer.py``): each step
hands it views of the stacked leaves, one a layer, each a leaf of the
graph whose ``.grad`` is preset to the matching view of a stacked grad
buffer. Autograd accumulates each layer's grad into that buffer in place
the moment it is ready, so no layer's grad outlives its layer's backward
and no stacked copy is made (an ``unbind`` would hold every layer's grad
until the last and then stack them: 16 GB more for llama3-8b).

Across devices, on the ranks of ``common.sharding`` (one process a
device, NCCL on the cards, gloo on the CPU):
  * ``make_train_step(mesh=)`` is the reference's GSPMD step on a
    ``(data, model)`` mesh: each leaf is held as this rank's block of its
    spec under a logical-axis rule table (FSDP over data, tensor parallel
    over model; ``models/parallel.py`` gathers a layer's blocks inside the
    layer and reduce-scatters its grads when they are complete), the
    batch split over data, leaves that the mesh replicates all-reduced
    after the backward, and AdamW on the blocks with a global norm
    (``optim/adamw.py``). Every family: MLA's latents on every rank and
    its heads over model, MoE's experts over model with each routing call
    the reference's across the data ranks (its microbatches re-dealt so),
    the mixers' channels and heads over model (``models/parallel.py``);
  * ``make_dp_compressed_step`` is the reference's data-parallel step with
    int8 error-feedback gradient collectives.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.common import sharding as SH
from repro_torch.common import tree as TR
from repro_torch.common.types import ModelConfig, TrainConfig
from repro_torch.common.utils import resolve_device
from repro_torch.models import parallel as PAR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, gradcomp

Tree = Any
STACKED = ("layers", "shared")


def _lead(cfg: ModelConfig, name: str) -> Tuple[int, ...]:
    """The stacked axes of ``params[name]``: [G, period] for the hybrid's
    Mamba2 layers, one axis otherwise."""
    if name == "layers" and cfg.family == "hybrid":
        g, period, _ = T.hybrid_groups(cfg)
        return (g, period)
    return (cfg.num_layers if name == "layers" else cfg.attn_shared_blocks,)


def stack_params(params: Tree, cfg: ModelConfig) -> Tree:
    """The model's params (per-layer lists) in the stacked layout; each
    leaf's per-layer tensors are released as soon as it is stacked."""
    out = {k: v for k, v in params.items() if k not in STACKED}
    for name in STACKED:
        if name not in params:
            continue
        layers, lead = params[name], _lead(cfg, name)

        def stack(path, _):
            *head, last = path
            t = torch.stack([TR.get(lp, tuple(head)).pop(last)
                             for lp in layers])
            return t.reshape(lead + t.shape[1:])

        out[name] = TR.map_with_paths(
            stack, TR.map_tree(lambda _: None, layers[0]))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Tree:
    """``transformer.init_params`` (random params from a seeded generator,
    on the card unless the caller names another) in the stacked layout."""
    return stack_params(T.init_params(cfg, seed, resolve_device(device)), cfg)


def _per_layer(stacked: Tree, cfg: ModelConfig, name: str, fn):
    """[fn(leaf's layer i) for each leaf] as a list of per-layer dicts."""
    n = 1
    for s in _lead(cfg, name):
        n *= s
    k = len(_lead(cfg, name))
    return [TR.map_tree(lambda *ts: fn(*(t.reshape((n,) + t.shape[k:])[i]
                                         for t in ts)), *stacked)
            for i in range(n)]


def model_view(params: Tree, cfg: ModelConfig) -> Tree:
    """The model's params: per-layer views of the stacked leaves."""
    out = {k: v for k, v in params.items() if k not in STACKED}
    for name in STACKED:
        if name in params:
            out[name] = _per_layer((params[name],), cfg, name, lambda t: t)
    return out


def _bound(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A leaf of the graph viewing ``p``, its grad accumulating into ``g``
    (a view of the grad buffer) in place."""
    x = p.detach().requires_grad_(True)
    x.grad = g
    return x


def _backward_into(params: Tree, grads: Tree, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, attn_impl: str,
                   mesh: "PAR.MeshModel" = None) -> torch.Tensor:
    """loss_fn's loss on ``batch``; its grads added into ``grads``. On a
    mesh the loss is this rank's rows' mean and the gradient that of the
    mean over the batch's ranks (the loss scaled by 1 / their count)."""
    view = {k: _bound(v, grads[k]) for k, v in params.items()
            if k not in STACKED}
    for name in STACKED:
        if name in params:
            view[name] = _per_layer((params[name], grads[name]), cfg, name,
                                    _bound)
    loss = T.loss_fn(view, batch, cfg, attn_impl, mesh)[0]
    if mesh is not None and mesh.batch_ways > 1:
        (loss / mesh.batch_ways).backward()
    else:
        loss.backward()
    return loss.detach()


def grads_and_loss(params: Tree, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, microbatches: int,
                   attn_impl: str = "auto", mesh: "PAR.MeshModel" = None
                   ) -> Tuple[Tree, torch.Tensor]:
    """(grads, loss). One microbatch: grads in the params' dtype. k > 1:
    each microbatch's grads (in the params' dtype) summed in float32 and
    scaled by 1/k, as the reference's ``lax.scan`` does. ``mesh``: the
    rank's blocks and rows (``make_train_step(mesh=)``; the MoE family's
    rows re-dealt first, ``_redeal``); the loss is the rank's rows', the
    grads not yet reduced over replicas."""
    def zeros(p, dtype=None):
        return torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)

    if microbatches <= 1:
        grads = TR.map_tree(zeros, params)
        return grads, _backward_into(params, grads, batch, cfg, attn_impl,
                                     mesh)
    k = microbatches
    if mesh is not None and mesh.batch_ways > 1 and cfg.family == "moe":
        batch = _redeal(batch, k, mesh)
    acc = TR.map_tree(lambda p: zeros(p, torch.float32), params)
    buf = TR.map_tree(zeros, params)
    lsum = None
    for i in range(k):
        mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
              for n, x in batch.items()}
        if i:
            for _, b in TR.leaves_with_paths(buf):
                b.zero_()
        loss = _backward_into(params, buf, mb, cfg, attn_impl, mesh)
        lsum = loss if lsum is None else lsum + loss
        for (_, a), (_, b) in zip(TR.leaves_with_paths(acc),
                                  TR.leaves_with_paths(buf)):
            a += b
    inv = 1.0 / k
    for _, a in TR.leaves_with_paths(acc):
        a *= inv
    return acc, lsum * inv


def _redeal(batch: Dict[str, torch.Tensor], k: int,
            mesh: "PAR.MeshModel") -> Dict[str, torch.Tensor]:
    """The rank's rows re-dealt so that its i-th microbatch is its share of
    the reference's i-th (global rows [i B / k, (i + 1) B / k), spread
    evenly over the batch's ranks): a routing call of the MoE family is
    then the reference's token set. Every rank's rows are gathered (B x S
    int32 tokens and labels) and the rank takes its own."""
    out = {}
    for name, x in batch.items():
        whole = mesh.mesh.gather(x, mesh.batch_spec)
        B, D = whole.shape[0], mesh.batch_ways
        if B % (k * D):
            raise ValueError(f"{B} rows do not split into {k} microbatches "
                             f"over {D} ranks")
        rows = whole.reshape((k, D, B // (k * D)) + whole.shape[1:])
        out[name] = rows[:, mesh.batch_index].reshape(
            (B // D,) + whole.shape[1:])
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    mesh: SH.Mesh = None, *, rules=SH.DEFAULT_RULES,
                    param_axes: Tree = None, attn_impl: str = "auto",
                    quantize_impl: str = "auto"):
    """Returns (train_step, shardings): ``train_step(params, opt, batch) ->
    (params, opt, metrics)`` with ``loss``, ``grad_norm`` and ``lr`` on the
    device; params and state are updated in place (the reference donates
    them). ``attn_impl``/``quantize_impl`` route B6 and B3/B4 ("auto": the
    kernels for CUDA tensors). Without a mesh, shardings is None.

    With ``mesh`` (a ``common.sharding.Mesh``; every rank calls the step):
    params and the state are this rank's blocks and ``batch`` this rank's
    rows; ``shardings`` holds ``TreeSharding``s of ``"params"``, ``"opt"``
    and ``"batch"`` (their ``specs`` and ``shard``/``gather`` of whole
    trees) from ``param_axes`` (default ``transformer.param_axes(cfg)``)
    under ``rules``. The loss in the metrics is the whole batch's."""
    ocfg = tcfg.optimizer

    def step(params: Tree, opt: adamw.AdamState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Tree, adamw.AdamState, Dict[str, torch.Tensor]]:
        grads, loss = grads_and_loss(params, batch, cfg, tcfg.microbatches,
                                     attn_impl)
        params, opt, metrics = adamw.update(grads, opt, params, ocfg,
                                            quantize_impl)
        metrics["loss"] = loss
        return params, opt, metrics

    if mesh is None:
        return step, None
    PAR.check_splits(cfg, mesh)
    specs = SH.tree_specs(T.param_axes(cfg) if param_axes is None
                          else param_axes, rules, mesh.axes)
    _check_mesh_specs(cfg, mesh, specs)
    shardings = mesh_shardings(cfg, ocfg, mesh, specs, rules)
    if mesh.size == 1:                  # shards nothing: the one-device step
        return step, shardings
    model = PAR.MeshModel(cfg, mesh, specs,
                          shardings["batch"].specs["tokens"])
    batch_axes = model.batch_axes
    psh = shardings["params"]

    def mesh_step(params: Tree, opt: adamw.AdamState,
                  batch: Dict[str, torch.Tensor]):
        grads, loss = grads_and_loss(params, batch, cfg, tcfg.microbatches,
                                     attn_impl, model)
        _reduce_replicas(grads, specs, mesh, batch_axes)
        params, opt, metrics = adamw.update(grads, opt, params, ocfg,
                                            quantize_impl, psh)
        metrics["loss"] = mesh.psum(loss, batch_axes) / model.batch_ways
        return params, opt, metrics

    return mesh_step, shardings


def _check_mesh_specs(cfg: ModelConfig, mesh: SH.Mesh, specs: Tree) -> None:
    """The mesh path's layout: no stacked axis sharded, and, on a model
    axis of more than one rank, "model" alone on the dims ``TRAIN_RULES``
    puts it on (heads, MLP columns, vocab): the products the forward runs
    tensor-parallel."""
    want = SH.TreeSharding(mesh, SH.tree_specs(
        T.param_axes(cfg), SH.DEFAULT_RULES, mesh.axes))
    tp = PAR.MODEL in mesh.sizes and mesh.axis_size(PAR.MODEL) > 1

    def model_dims(spec):
        return [i for i, e in enumerate(spec)
                if PAR.MODEL in SH._entry_axes(e)]

    for path, spec in SH.spec_leaves(specs):
        name = "/".join(path)
        if path[0] in STACKED and mesh.spec_axes(spec[:1]):
            raise NotImplementedError(f"{name}: spec {spec} shards the "
                                      "stacked layers axis")
        dims = model_dims(spec)
        if tp and (dims != model_dims(want.spec(path)) or
                   any(spec[i] != PAR.MODEL for i in dims)):
            raise NotImplementedError(
                f"{name}: spec {spec}; the mesh runs the model axis alone on "
                f"the dims TRAIN_RULES gives ({want.spec(path)})")


def mesh_shardings(cfg: ModelConfig, ocfg, mesh: SH.Mesh, specs: Tree,
                   rules) -> Dict[str, SH.TreeSharding]:
    """The params', state's and batch's ``TreeSharding``s: raw moments as
    their params, compressed ones replicated whole (the reference's
    ``_opt_tree_shardings``). Only ``mesh.axes`` is read to make the specs
    (the dry run passes a ``MeshConfig``)."""
    if ocfg.compress_state:
        moments = SH.map_specs(lambda _: {"codes": (), "scales": (),
                                          "block": ()}, specs)
    else:
        moments = specs
    rows = SH.logical_to_spec(("batch", "seq"), rules, mesh.axes)
    batch = {"tokens": rows, "labels": rows}
    if cfg.frontend != "none":
        batch["embeds"] = SH.logical_to_spec(("batch", "seq", "embed"),
                                             rules, mesh.axes)
    return {"params": SH.TreeSharding(mesh, specs),
            "opt": SH.TreeSharding(mesh, adamw.AdamState((), moments,
                                                         moments)),
            "batch": SH.TreeSharding(mesh, batch)}


def _reduce_replicas(grads: Tree, specs: Tree, mesh: SH.Mesh,
                     batch_axes) -> None:
    """Sum in place each gradient over the batch's axes its leaf is not
    sharded over (the replicated leaves: the norms, and the vocab
    leaves over data), one all_reduce for each set of such axes."""
    groups: Dict[Tuple, list] = {}
    for path, spec in SH.spec_leaves(specs):
        g = TR.get(grads, path)
        axes = tuple(a for a in batch_axes if a not in mesh.spec_axes(spec))
        if axes:
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in groups.items():
        flat = mesh.psum(torch.cat([g.reshape(-1) for g in gs]), axes)
        o = 0
        for g in gs:
            g.copy_(flat[o:o + g.numel()].view(g.shape))
            o += g.numel()


def make_dp_compressed_step(cfg: ModelConfig, tcfg: TrainConfig,
                            group: SH.ExpanderGroup = None, *,
                            attn_impl: str = "auto",
                            quantize_impl: str = "auto"):
    """The reference's data-parallel step with int8 error-feedback gradient
    collectives, on D ranks (``group``; default: the one
    ``common.sharding.init_expander_ranks`` joined, none raises).

    ``step(params, opt, residual, batch) -> (params, opt, residual,
    metrics)``: params and state replicated on every rank; ``batch`` is this
    rank's rows of the global batch (rank r holds rows r B/D .. (r+1) B/D);
    ``residual`` this rank's error-feedback row (``init_residual_flat(params,
    1)``: [1, size] a leaf). Per leaf of n values, as the reference: when
    ``n % D`` or ``n < 4 D``, a plain mean; otherwise the rank's slice of
    the summed gradient over D (the reference's reduce-scatter: here an
    all_reduce and the rank's own slice), 8-bit codes of slice + residual
    (B3 ``encode``), the residual's update (B4 ``decode``), every rank's
    codes and scales gathered (one masked all_reduce) and decoded (B4).
    Then ``adamw.update`` on every rank. Wire bytes a step are not the
    reference's 1.25x the gradient's: the all_reduce moves the float32
    gradient whole (backends offer no reduce-scatter on gloo's CUDA path).
    Params, state and residual are updated in place; ``metrics`` has
    ``loss`` (the mean over ranks), ``grad_norm`` and ``lr`` on the
    device."""
    group = SH.current_group() if group is None else group
    ocfg = tcfg.optimizer

    def step(params: Tree, opt: adamw.AdamState, residual: Tree,
             batch: Dict[str, torch.Tensor]):
        grads, loss = grads_and_loss(params, batch, cfg, tcfg.microbatches,
                                     attn_impl)
        loss = group.psum(loss) / group.world
        grads = mean_grads(grads, residual, group, quantize_impl)
        params, opt, metrics = adamw.update(grads, opt, params, ocfg,
                                            quantize_impl)
        metrics["loss"] = loss
        return params, opt, residual, metrics

    return step


def mean_grads(grads: Tree, residual: Tree, group: SH.ExpanderGroup,
               quantize_impl: str = "auto") -> Tree:
    """The ranks' mean gradient, leaf by leaf as the reference's DP step
    (``make_dp_compressed_step``): float32, every rank's the same; this
    rank's residual rows updated in place."""
    ndev, rank = group.world, group.rank

    def one(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        gf = g.to(torch.float32)
        flat = gf.reshape(-1)
        n = flat.numel()
        if n % ndev or n < 4 * ndev:          # tiny leaves: plain mean
            return group.psum(gf) / ndev
        ns = n // ndev
        shard = group.psum(flat)[rank * ns:(rank + 1) * ns] / ndev
        corrected = shard + r[0, :ns]
        blk = gradcomp._block_for(ns, 512)
        c = gradcomp.compress_leaf(corrected, blk, quantize_impl)
        r[0, :ns] = corrected - gradcomp.decompress_leaf(c, (ns,), blk,
                                                         quantize_impl)
        full = gradcomp.decompress_leaf(group.gather_tree(c), (n,), blk,
                                        quantize_impl)
        return full.reshape(g.shape)

    return TR.map_tree(one, grads, residual)


def init_residual_flat(params: Tree, ndev: int) -> Tree:
    """Per-device error-feedback residuals: [ndev, size] float32 zeros (a
    rank of ``make_dp_compressed_step`` holds its own row: ``ndev`` 1)."""
    return TR.map_tree(lambda p: torch.zeros((ndev, p.numel()),
                                             dtype=torch.float32,
                                             device=p.device), params)


def run_dp_steps(group: SH.ExpanderGroup, cfg: ModelConfig,
                 tcfg: TrainConfig, params: Tree, batches, *,
                 attn_impl: str = "auto", quantize_impl: str = "auto"):
    """A rank entry point (``common.sharding.spawn_ranks``): the
    data-parallel step over ``batches`` (global batches of numpy arrays;
    this rank takes its rows) from ``params`` (the reference's stacked tree
    of numpy arrays), the state and residuals starting at zero. Returns on
    rank 0 the losses and the end state as numpy (params, the AdamW state,
    every rank's residual row gathered: [D, size] a leaf); None on the
    others."""
    from repro_torch import interop
    dev = group.device
    p = interop.stacked_params_from_numpy(params, cfg, dev)
    opt = adamw.init(p, tcfg.optimizer, quantize_impl)
    res = init_residual_flat(p, 1)
    step = make_dp_compressed_step(cfg, tcfg, group, attn_impl=attn_impl,
                                   quantize_impl=quantize_impl)
    losses = []
    for b in batches:
        rows = {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in b.items()}
        n = next(iter(rows.values())).shape[0] // group.world
        rows = {k: v[group.rank * n:(group.rank + 1) * n]
                for k, v in rows.items()}
        p, opt, res, m = step(p, opt, res, rows)
        losses.append(m["loss"])
    flat = {"/".join(map(str, k)): v for k, v in TR.leaves_with_paths(res)}
    got = group.gather_tree(flat)
    if group.rank:
        return None
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "params": interop.stacked_params_to_numpy(p),
            "opt": interop.opt_state_to_numpy(opt),
            "residual": {k: v.cpu().numpy() for k, v in got.items()}}


def mean_grads_on_ranks(group: SH.ExpanderGroup, grads, residuals,
                        quantize_impl: str = "auto"):
    """A rank entry point: ``mean_grads`` of rank r's gradient tree
    ``grads[r]`` with its residual rows ``residuals[r]`` (numpy trees).
    Returns (the mean gradient, this rank's updated residual) as numpy on
    every rank."""
    def dev(tree):
        return TR.map_tree(lambda a: torch.from_numpy(np.array(a)).to(
            group.device), tree)
    res = dev(residuals[group.rank])
    out = mean_grads(dev(grads[group.rank]), res, group, quantize_impl)
    host = TR.map_tree(lambda t: t.cpu().numpy(), (out, res))
    return host


def run_mesh_steps(group: SH.ExpanderGroup, cfg: ModelConfig,
                   tcfg: TrainConfig, mesh_shape, params, batches, *,
                   ckpt_dir: str = None, save_at=(), restore_step=None):
    """A rank entry point (``common.sharding.spawn_ranks``): the mesh step
    on a ``(data, model)`` mesh of ``mesh_shape`` over the group's ranks,
    from ``params`` (the reference's stacked tree of numpy arrays; the rank
    takes its blocks) with the state at zero, or with ``restore_step`` from
    that checkpoint in ``ckpt_dir``, over ``batches`` (global batches of
    numpy arrays; the rank takes its rows). For each i in ``save_at`` the
    state after i steps is saved to ``ckpt_dir`` as step i. Returns on rank
    0 the losses and grad norms and the end state gathered whole, as numpy;
    None on the others."""
    from repro_torch import interop
    from repro_torch.common.types import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as ckpt
    dev = group.device
    mesh = make_mesh(MeshConfig(shape=tuple(mesh_shape),
                                axes=("data", "model")), group)
    step, sh = make_train_step(cfg, tcfg, mesh)
    both = SH.TreeSharding.join({"params": sh["params"], "opt": sh["opt"]})
    p = sh["params"].shard(interop.stacked_params_from_numpy(params, cfg,
                                                             dev))
    opt = adamw.init(p, tcfg.optimizer, sharding=sh["params"])
    if restore_step is not None:
        tree, _ = ckpt.restore(ckpt_dir, restore_step,
                               {"params": p, "opt": opt}, shardings=both)
        p, opt = tree["params"], tree["opt"]
    losses, norms = [], []
    for i, b in enumerate(batches):
        if i in save_at:
            ckpt.save(ckpt_dir, i, {"params": p, "opt": opt}, shardings=both)
        rows = sh["batch"].shard({k: torch.from_numpy(np.asarray(v)).to(dev)
                                  for k, v in b.items()})
        p, opt, m = step(p, opt, rows)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    if len(batches) in save_at:
        ckpt.save(ckpt_dir, len(batches), {"params": p, "opt": opt},
                  shardings=both)
    whole = both.gather({"params": p, "opt": opt})
    if group.rank:
        return None
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "grad_norms": [float(x) for x in torch.stack(norms).cpu()],
            "params": interop.stacked_params_to_numpy(whole["params"]),
            "opt": interop.opt_state_to_numpy(whole["opt"])}
