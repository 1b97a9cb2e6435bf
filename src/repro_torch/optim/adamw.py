"""AdamW with optional IBEX-compressed optimizer state (the reference's
``repro.optim.adamw``).

``compress_state=True`` stores both Adam moments block-quantized: 8-bit m
and 8-bit sqrt(v) (squared back on use) with an f32 scale per block of
``state_block`` values, or one block for the whole leaf where the leaf is
shorter or does not divide (``_blk``). That is about 2.06 bytes a parameter
instead of 8. The codes go through B3 ``encode`` and come back through B4
``decode`` (``core/compressor.py``'s fast paths: the CUDA kernels for CUDA
tensors, bit-identical to their plain versions).

The port's own choices, none of which changes the function:
  * ``update`` works leaf by leaf in slices of whole blocks of at most
    ``SLICE_VALUES`` values: every operation is elementwise and the
    quantization is per block, so the slices give the same result, and no
    float32 temporary of a whole leaf is made (llama3-8b's stacked MLP
    leaf is 1.879e9 values, 7.5 GB in float32). The global norm is taken
    over all grads first, also in slices.
  * Params, moments and codes are updated in place (the reference's jitted
    step donates them).
  * On a mesh (``sharding``: the params' ``common.sharding.TreeSharding``)
    params, grads and raw moments are this rank's blocks and the update is
    the same elementwise pass over them. The global norm sums each block
    once (on the rank that holds its first copy) and all-reduces the sum
    over the mesh. Compressed moments are replicated whole, as the
    reference lays them out (``_opt_tree_shardings``): the leaf's gradient
    and param are gathered whole, updated in slices as without a mesh, and
    the rank keeps its block of the param, so the codes depend on the
    gathered gradient only.
  * A compressed leaf's ``block`` is a host int under the reference's key
    (the reference keeps an int32 array and reads it with ``int()``,
    which under ``jit`` raises: ROADMAP C11). The step, the clip factor,
    the learning rate and the bias corrections stay on the device, so an
    update makes no host sync.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.common import tree as TR
from repro_torch.common.types import OptimizerConfig
from repro_torch.core.compressor import dequantize_blocks, quantize_blocks_fast

Params = Any
SLICE_VALUES = 1 << 26          # values of one slice of a leaf's update
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, 0-dim, on the params' device
    m: Params            # raw moments, or {"codes", "scales", "block"} a leaf
    v: Params


def _blk(n: int, block: int) -> int:
    return block if n % block == 0 and n >= block else n


def _slices(n: int, b: int):
    """[start, stop) ranges of whole blocks of b values over n values, each
    at most SLICE_VALUES long (one block where a block is longer)."""
    step = max(SLICE_VALUES // b, 1) * b
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _compress_leaf(x: torch.Tensor, block: int, impl: str = "auto"):
    """8-bit codes and f32 scales of ``x`` flattened, in blocks of
    ``_blk(n, block)``: a slice of whole blocks of a leaf gives that leaf's
    codes of the slice."""
    flat = x.reshape(-1)
    b = _blk(flat.numel(), block)
    codes, scales = quantize_blocks_fast(flat, 8, b, impl)
    return {"codes": codes, "scales": scales, "block": b}


def _decompress_leaf(c, shape, impl: str = "auto") -> torch.Tensor:
    """The moment in float32, in blocks of the leaf's own ``block`` (the
    reference's third argument, unused there too, is dropped)."""
    return dequantize_blocks(c["codes"], c["scales"], 8, c["block"],
                             torch.float32, impl).reshape(shape)


def _compressed_zeros(p: torch.Tensor, block: int, impl: str, n: int):
    """``_compress_leaf`` of a float32 zero leaf of ``n`` values on ``p``'s
    device, made in slices."""
    b = _blk(n, block)
    out = {"codes": torch.empty((n,), dtype=torch.uint8, device=p.device),
           "scales": torch.empty((n // b,), dtype=torch.float32,
                                 device=p.device), "block": b}
    for s, e in _slices(n, b):
        _store(out, s, e, _compress_leaf(torch.zeros(
            (e - s,), dtype=torch.float32, device=p.device), block, impl))
    return out


def _store(c, s: int, e: int, part) -> None:
    """Values [s, e) of the compressed leaf ``c`` from ``part``'s codes."""
    b = c["block"]
    c["codes"][s:e] = part["codes"]
    c["scales"][s // b:e // b] = part["scales"]


def _part(c, s: int, e: int):
    """Values [s, e) of the compressed leaf ``c`` (whole blocks)."""
    b = c["block"]
    return {"codes": c["codes"][s:e], "scales": c["scales"][s // b:e // b],
            "block": b}


def init(params: Params, cfg: OptimizerConfig, impl: str = "auto",
         sharding=None) -> AdamState:
    """Zero moments for ``params`` (on a mesh: this rank's blocks, whose
    compressed moments cover the whole leaf)."""
    dev = next(t for _, t in TR.leaves_with_paths(params)).device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.compress_state:
        def comp(path, p):
            shape = p.shape if sharding is None else \
                sharding.mesh.full_shape(p.shape, sharding.spec(path))
            return _compressed_zeros(p, cfg.state_block, impl,
                                     int(torch.Size(shape).numel()))
        return AdamState(step, TR.map_with_paths(comp, params),
                         TR.map_with_paths(comp, params))
    mdt = MOMENT_DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return AdamState(step, TR.map_tree(zeros, params),
                     TR.map_tree(zeros, params))


def _lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree: Params, sharding=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a leaf's sum in
    slices of ``SLICE_VALUES``). On a mesh: each block counted on the rank
    that holds its first copy, the sum all-reduced over the mesh."""
    total = None
    for path, x in TR.leaves_with_paths(tree):
        if sharding is not None and \
                not sharding.mesh.owns(sharding.spec(path)):
            continue
        flat = x.reshape(-1)
        for s, e in _slices(flat.numel(), 1):
            part = torch.sum(flat[s:e].to(torch.float32) ** 2)
            total = part if total is None else total + part
    if sharding is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=sharding.mesh.device)
        total = sharding.mesh.psum(total)
    return torch.sqrt(total)


def update(grads: Params, state: AdamState, params: Params,
           cfg: OptimizerConfig, impl: str = "auto", sharding=None
           ) -> Tuple[Params, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step: params, moments and codes updated in place and
    returned, with {"grad_norm", "lr"} on the device. ``impl`` routes the
    compressed state's codec ("auto": the kernels for CUDA tensors);
    ``sharding``: the params' layout on a mesh (module docstring)."""
    f32 = torch.float32
    step = state.step + 1
    gnorm = global_norm(grads, sharding)
    clip = torch.clamp(torch.full((), cfg.grad_clip, dtype=f32,
                                  device=gnorm.device) /
                       torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _lr_at(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.to(f32)
    bc2 = 1.0 - cfg.b2 ** step.to(f32)
    mdt = MOMENT_DTYPES[cfg.moment_dtype]

    for path, p in TR.leaves_with_paths(params):
        g_leaf, p_leaf = TR.get(grads, path), p
        if sharding is not None and cfg.compress_state:   # the whole leaf
            spec = sharding.spec(path)
            g_leaf = sharding.mesh.gather(g_leaf, spec)
            p_leaf = sharding.mesh.gather(p, spec)
        g_all = g_leaf.reshape(-1)
        p_all = p_leaf.view(-1)
        m_c, v_c = TR.get(state.m, path), TR.get(state.v, path)
        b = m_c["block"] if cfg.compress_state else 1
        for s, e in _slices(p_all.numel(), b):
            g = g_all[s:e].to(f32) * clip
            if cfg.compress_state:
                m = _decompress_leaf(_part(m_c, s, e), (e - s,), impl)
                # v stored on a sqrt-companded scale to keep its range
                v = _decompress_leaf(_part(v_c, s, e), (e - s,), impl) ** 2
            else:
                m = m_c.view(-1)[s:e].to(f32)
                v = v_c.view(-1)[s:e].to(f32)
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            pf = p_all[s:e].to(f32)
            upd = mhat / (torch.sqrt(vhat) + cfg.eps) + \
                cfg.weight_decay * pf
            p_all[s:e] = (pf - lr * upd).to(p.dtype)
            if cfg.compress_state:
                _store(m_c, s, e, _compress_leaf(m, cfg.state_block, impl))
                _store(v_c, s, e, _compress_leaf(torch.sqrt(v),
                                                 cfg.state_block, impl))
            else:
                m_c.view(-1)[s:e] = m.to(mdt)
                v_c.view(-1)[s:e] = v.to(mdt)
        if p_leaf is not p:                  # this rank's block of the leaf
            p.copy_(sharding.mesh.shard(p_leaf, spec))
    state = AdamState(step, state.m, state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_bytes(state: AdamState) -> int:
    """Bytes of the state's leaves; a compressed leaf's host ``block``
    counts as the reference's int32."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else 4 for _, x in TR.leaves_with_paths(state))
