"""What one step of the port costs a rank, counted from the model config,
the rule tables and the meta device: the port's counterpart of what XLA's
``cost_analysis()`` and the post-SPMD HLO give the reference's dry run.

For the train, prefill and decode steps of every arch id at a given
(config, shape, mesh, ``TrainConfig``/``ServeConfig``), per rank:

* **Executed matmul FLOPs** (``matmul_flops``): every product the port
  runs, as ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (``mm``/``bmm``, an einsum as its ``bmm``): the forward, remat's second
  forward of each layer (or hybrid group), and the backward at twice each
  product. Remat's second forward is ``torch.utils.checkpoint``'s, which
  stops once the last tensor the backward needs is recomputed: a unit
  whose last operation is a product (the MLP's or the mixer's ``wo``, then
  a residual add that saves nothing) does not run that product again. The
  MoE dispatch is counted as the port computes it: each expert's buffer
  of C rows, drops and padding included (``models/moe.py::capacity``).
  Attention on the ``"plain"`` route (the CPU's) is the online-softmax
  einsums over every key; on the ``"kernel"`` route (the card's) B6's
  forward counts the causal pairs and its PyTorch backward
  (``flash_attention_backward``) five products over every key. The SSM
  scans' C contraction counts once more in the backward: the chunk's
  backward (``models/ssm.py::_ScanChunk``) recomputes it to differentiate
  it. Microbatches count each microbatch at its rows.
* **The float32 part of them** (``f32=True``), priced at the f32 peak:
  every product of a float32 model; in a bf16 model the SSM scans' C
  contraction (float32 state), attention on the plain route, B6's
  backward on the kernel route, and decode's attention over the cache
  (B5's GQA kernel and the ring's partial on the CUDA cores; MLA's latent
  kernel takes the tensor cores and is left in bf16).
* **FLOPs outside matmuls** (``other_flops``), by formula and kept apart:
  softmax (5 a score), RMSNorm (4 a value), the SwiGLU gate (5 a hidden
  value), the SSM scans (3 a state value a Hillis-Steele pass, 4 for the
  decay and input, 2 for the carry), the loss's log-softmax (5 a logit);
  the backward at twice the forward's.
* **Model FLOPs**: ``analyze.model_flops``, 6 N_active D or 2 N_active D.
* **A floor of HBM bytes** (``hbm_bytes``): each param byte read by the
  forward, remat's forward and the backward and once more by the update
  (and written once); each grad byte written once a microbatch and read
  by the norm and the update; each state byte read and written once; the
  saved layer inputs written and read once; the logits and their grad
  written and read once. A floor: every other intermediate is left out.
* **Collective bytes by kind, as ``common/sharding.Mesh`` moves them**:
  the bytes of the tensors a rank hands ``all_reduce`` and ``broadcast``.
  A gather is each rank's broadcast of its block in turn (the rank takes
  part in all of them: the whole leaf's bytes, counted as "all-gather"),
  a reduce-scatter an all_reduce of the whole (zero-padded) leaf, a psum
  an all_reduce (both "all-reduce"). Serve cells get none, with the
  reason: the port serves on one device.

Per rank: the whole program's FLOPs over the ranks (the mesh step splits
every product over ``model`` and the batch over ``data``), the bytes of
the rank's own blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import sharding as SH
from repro_torch.common import tree as TR
from repro_torch.common.types import (MLAConfig, MoEConfig, ModelConfig,
                                      ServeConfig, SSMConfig, TrainConfig)
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as PAR
from repro_torch.models import transformer as T

ACT_BYTES = {"bfloat16": 2, "float32": 4}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
SERVE_REASON = "the port serves on one device: no collective"


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * \
        torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Products: (name, flops) of one remat unit's forward, in execution order.
# ---------------------------------------------------------------------------

def _attention(rows: int, sq: int, sk: int, heads: int, qk: int, v: int,
               route: str, causal: bool = True):
    """(forward products, backward flops) of one attention call."""
    full = 2 * rows * heads * sq * sk
    if route == "plain":
        fwd = [("attn_qk", full * qk), ("attn_pv", full * v)]
        return fwd, 2 * full * (qk + v)
    pairs = sq * (sq + 1) // 2 + sq * (sk - sq) if causal else sq * sk
    fwd = [("attn_qk", 2 * rows * heads * pairs * qk),
           ("attn_pv", 2 * rows * heads * pairs * v)]
    return fwd, full * (3 * qk + 2 * v)


def _gqa_block(cfg: ModelConfig, rows: int, seq: int, route: str):
    """An attention + MLP (or experts) block: (products, attention's
    backward flops)."""
    n = rows * seq
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        m = cfg.mla or MLAConfig()
        R, qk = m.kv_lora_rank + m.qk_rope_head_dim, \
            m.qk_nope_head_dim + m.qk_rope_head_dim
        attn, bwd = _attention(rows, seq, seq, hq, qk, m.v_head_dim, route)
        prods = [("wkv_a", 2 * n * d * R), ("wq_a", 2 * n * d * m.q_lora_rank),
                 ("wq_b", 2 * n * m.q_lora_rank * hq * qk),
                 ("wkv_b", 2 * n * m.kv_lora_rank * hq *
                  (m.qk_nope_head_dim + m.v_head_dim))] + attn + \
            [("wo", 2 * n * hq * m.v_head_dim * d)]
    else:
        attn, bwd = _attention(rows, seq, seq, hq, hd, hd, route)
        prods = [("wq", 2 * n * d * hq * hd), ("wk", 2 * n * d * hkv * hd),
                 ("wv", 2 * n * d * hkv * hd)] + attn + \
            [("wo", 2 * n * hq * hd * d)]
    return prods + _mlp(cfg, rows, seq), bwd


def _dense_mlp(n: int, d: int, f: int):
    return [("mlp_wg", 2 * n * d * f), ("mlp_wi", 2 * n * d * f),
            ("mlp_wo", 2 * n * f * d)]


def moe_rows(cfg: ModelConfig, n: int) -> int:
    """Rows of the experts' batched products for n tokens in one call: E x
    C (sorted form) or E x G x C (grouped, from 2 x GROUP_TOKENS tokens)."""
    mo = cfg.moe or MoEConfig()
    e, k = mo.num_experts, mo.top_k
    if n >= 2 * MOE.GROUP_TOKENS:
        sg = min(MOE.GROUP_TOKENS, n)
        return e * (n // sg) * MOE.capacity(k, sg, e)
    return e * MOE.capacity(k, n, e)


def _mlp(cfg: ModelConfig, rows: int, seq: int):
    n, d = rows * seq, cfg.d_model
    if cfg.family != "moe":
        return _dense_mlp(n, d, cfg.d_ff)
    mo = cfg.moe or MoEConfig()
    r, f = moe_rows(cfg, n), mo.expert_d_ff
    out = [("router", 2 * n * d * mo.num_experts),
           ("experts_wg", 2 * r * d * f), ("experts_wi", 2 * r * d * f),
           ("experts_wo", 2 * r * f * d),
           ("combine", 2 * n * mo.top_k * d)]
    if mo.dense_residual:
        out += _dense_mlp(n, d, mo.dense_d_ff or cfg.d_ff)
    # the load-balance loss follows the last product and saves tensors, so
    # remat's second forward runs every product again
    return out + [("aux", 0)]


def _mamba(cfg: ModelConfig, rows: int, seq: int):
    """A mixer's products (Mamba1 for the SSM family, Mamba2 for the
    hybrid's)."""
    n, d = rows * seq, cfg.d_model
    if cfg.family == "hybrid":
        ssm = cfg.ssm or SSMConfig(kind="mamba2")
        d_in = ssm.expand * d
        H = d_in // ssm.headdim
        return [("in_proj", 2 * n * d * (2 * d_in + 2 * ssm.ngroups *
                                         ssm.d_state + H)),
                ("ssm_contract", 2 * n * d_in * ssm.d_state),
                ("out_proj", 2 * n * d_in * d)]
    ssm = cfg.ssm or SSMConfig()
    d_in, r, N = ssm.expand * d, max(1, d // 16), ssm.d_state
    return [("in_proj", 2 * n * d * 2 * d_in),
            ("x_proj", 2 * n * d_in * (r + 2 * N)),
            ("dt_proj", 2 * n * r * d_in),
            ("ssm_contract", 2 * n * d_in * N),
            ("out_proj", 2 * n * d_in * d)]


def remat_unit(cfg: ModelConfig, rows: int, seq: int, route: str):
    """(the forward products, the attention's backward flops, how many)
    of the unit remat wraps (a layer; the hybrid's group with its shared
    block) at ``rows`` x ``seq`` tokens."""
    if cfg.family == "ssm":
        return _mamba(cfg, rows, seq), 0, cfg.num_layers
    if cfg.family == "hybrid":
        g, period, _ = T.hybrid_groups(cfg)
        block, bwd = _gqa_block(cfg, rows, seq, route)
        return _mamba(cfg, rows, seq) * period + block, bwd, g
    block, bwd = _gqa_block(cfg, rows, seq, route)
    return block, bwd, cfg.num_layers


def remat_unit_count(cfg: ModelConfig) -> int:
    """Units remat wraps: the layers, or the hybrid's groups."""
    return remat_unit(cfg, 1, 1, "plain")[2]


def _sum(prods) -> int:
    return sum(f for _, f in prods)


def _is_attn(name: str) -> bool:
    return name.startswith("attn_")


def _keep(cfg: ModelConfig, route: str, f32: bool):
    """Which products to count: all, or (``f32``) those that run in
    float32 (the module docstring); "attn_bwd" names the attention's
    backward."""
    if not f32 or cfg.dtype == "float32":
        return lambda name: True
    return lambda name: name in ("ssm_contract", "attn_bwd") or (
        route == "plain" and _is_attn(name))


def train_matmul_flops(cfg: ModelConfig, rows: int, seq: int,
                       route: str = "kernel", remat: Optional[bool] = None,
                       f32: bool = False) -> int:
    """Executed matmul FLOPs of one forward and backward (``loss_fn``'s
    graph) over ``rows`` x ``seq`` tokens: the whole program, one device;
    with ``f32`` only those that run in float32."""
    remat = cfg.remat if remat is None else remat
    keep = _keep(cfg, route, f32)
    prods, attn_bwd, times = remat_unit(cfg, rows, seq, route)
    kept = [p for p in prods if keep(p[0])]
    fwd = _sum(kept)
    again = fwd - (prods[-1][1] if keep(prods[-1][0]) else 0) if remat \
        else 0
    bwd = 2 * _sum(p for p in kept if not _is_attn(p[0])) + \
        _sum(p for p in kept if p[0] == "ssm_contract") + \
        (attn_bwd if keep("attn_bwd") else 0)
    unembed = 2 * rows * seq * cfg.d_model * cfg.vocab_size
    return times * (fwd + again + bwd) + (3 * unembed if keep("unembed")
                                          else 0)


def _sites(cfg: ModelConfig) -> int:
    """Attention + MLP blocks a token passes in one forward."""
    if cfg.family == "ssm":
        return 0
    return T.hybrid_groups(cfg)[0] if cfg.family == "hybrid" else \
        cfg.num_layers


def other_flops(cfg: ModelConfig, rows: int, seq: int, kind: str) -> int:
    """FLOPs outside matmuls of one step (the module docstring's formula):
    ``kind`` "train" (forward, remat's forward and a backward at twice the
    forward), "prefill" (one forward over ``seq`` tokens) or "decode" (one
    token over a context of ``seq``)."""
    decode = kind == "decode"
    n, d, sites = rows * (1 if decode else seq), cfg.d_model, _sites(cfg)
    # a block's two norms, a mixer's one (Mamba2's gated norm one more),
    # the final norm
    mixers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    norms = 2 * sites + mixers * (1 + (cfg.family == "hybrid")) + 1
    out = 4 * n * d * norms
    if sites:
        scores = seq if decode else seq * (seq + 1) // 2
        f = cfg.moe.expert_d_ff * cfg.moe.top_k if cfg.family == "moe" \
            else cfg.d_ff
        out += 5 * sites * (rows * cfg.num_heads * scores + n * f)
    if mixers:
        ssm = cfg.ssm or SSMConfig()
        state = ssm.expand * d * ssm.d_state
        c = 1 if decode else min(ssm.chunk, seq)
        passes = sum(c - (1 << i) for i in range(c.bit_length())
                     if (1 << i) < c)
        steps = 1 if decode else seq
        out += mixers * rows * (3 * (steps // c) * passes + 6 * steps) * \
            state
    if kind == "train":
        out += 5 * n * cfg.vocab_size            # the loss's log-softmax
        out *= 3 + int(cfg.remat)
    return int(out)


# ---------------------------------------------------------------------------
# Serve steps.
# ---------------------------------------------------------------------------

def prefill_matmul_flops(cfg: ModelConfig, rows: int, seq: int,
                         route: str = "kernel", f32: bool = False) -> int:
    """Executed matmul FLOPs of ``models/decode.py::prefill`` over ``rows``
    x ``seq`` prompt tokens: the full forward and the last token's
    logits; with ``f32`` only those that run in float32."""
    keep = _keep(cfg, route, f32)
    prods, _, times = remat_unit(cfg, rows, seq, route)
    return times * _sum(p for p in prods if keep(p[0])) + \
        (2 * rows * cfg.d_model * cfg.vocab_size if keep("unembed") else 0)


def decode_matmul_flops(cfg: ModelConfig, rows: int, ctx: int,
                        f32: bool = False) -> int:
    """Executed matmul FLOPs of one ``decode_step`` of ``rows`` lanes over
    a cache of ``ctx`` positions (the compressed region and the ring);
    with ``f32`` only those that run in float32."""
    if f32 and cfg.dtype != "float32":
        if cfg.attn_kind == "mla":
            return 0
        scan = cfg.num_layers * _sum(
            p for p in _mamba(cfg, rows, 1) if p[0] == "ssm_contract") \
            if cfg.family in ("ssm", "hybrid") else 0
        sites = T.hybrid_groups(cfg)[0] if cfg.family == "hybrid" else \
            (0 if cfg.family == "ssm" else cfg.num_layers)
        return scan + sites * 4 * rows * cfg.num_heads * ctx * \
            cfg.resolved_head_dim
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    unembed = 2 * rows * d * cfg.vocab_size

    def gqa():
        hkv = cfg.num_kv_heads
        return (2 * rows * d * (hq + 2 * hkv) * hd + 4 * rows * hq * ctx *
                hd + 2 * rows * hq * hd * d + _sum(_mlp(cfg, rows, 1)))

    if cfg.family == "ssm":
        return cfg.num_layers * _sum(_mamba(cfg, rows, 1)) + unembed
    if cfg.family == "hybrid":
        return cfg.num_layers * _sum(_mamba(cfg, rows, 1)) + \
            T.hybrid_groups(cfg)[0] * gqa() + unembed
    if cfg.attn_kind == "mla":
        m = cfg.mla or MLAConfig()
        R, Rc = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
        layer = (2 * rows * d * R + 2 * rows * d * m.q_lora_rank +
                 2 * rows * m.q_lora_rank * hq *
                 (m.qk_nope_head_dim + m.qk_rope_head_dim) +
                 2 * rows * hq * m.qk_nope_head_dim * Rc +
                 4 * rows * hq * ctx * R + 2 * rows * hq * Rc * m.v_head_dim +
                 2 * rows * hq * m.v_head_dim * d +
                 _sum(_dense_mlp(rows, d, cfg.d_ff)))
        return cfg.num_layers * layer + unembed
    return cfg.num_layers * gqa() + unembed


# ---------------------------------------------------------------------------
# Per-rank blocks.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Block:
    path: Tuple
    full: Tuple[int, ...]
    local: Tuple[int, ...]
    spec: Tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return _nbytes(self.local, self.dtype)

    @property
    def numel(self) -> int:
        return int(np.prod(self.local, dtype=np.int64))


def blocks(tree, specs, mesh_shape, mesh_axes) -> List[Block]:
    """Every leaf of ``tree`` (tensors, e.g. on the meta device; a host
    int, a compressed moment's block, as an int32 scalar) as this rank's
    block under the matching spec of ``specs``; a dim that does not split
    evenly raises."""
    sizes = dict(zip(mesh_axes, mesh_shape))
    out = []
    for path, x in TR.leaves_with_paths(tree):
        spec = specs if SH._is_spec(specs) else TR.get(specs, path)
        if not isinstance(x, torch.Tensor):
            out.append(Block(path, (), (), (), torch.int32))
            continue
        out.append(Block(path, tuple(x.shape),
                         SH.block_shape(x.shape, spec, sizes), spec,
                         x.dtype))
    return out


def total_bytes(bs: List[Block]) -> int:
    return sum(b.nbytes for b in bs)


# ---------------------------------------------------------------------------
# Collectives of the mesh train step.
# ---------------------------------------------------------------------------

def _empty_collectives() -> Dict[str, Any]:
    out: Dict[str, Any] = {k: 0.0 for k in COLLECTIVE_KINDS}
    out["by_use"] = {"gather": 0.0, "scatter": 0.0, "psum": 0.0,
                     "logits": 0.0, "batch": 0.0, "replicas": 0.0,
                     "update": 0.0}
    return out


def _unit_lead(cfg: ModelConfig, stack: str) -> int:
    """Stacked dims of a leaf of ``params[stack]``."""
    return 2 if stack == "layers" and cfg.family == "hybrid" else 1


def _unit_uses(cfg: ModelConfig, blk: Block) -> int:
    """How many times a forward runs a stacked leaf's layers: each layer
    once; the hybrid's shared blocks once a group."""
    if blk.path[0] == "shared":
        return T.hybrid_groups(cfg)[0]
    return int(np.prod(blk.full[:_unit_lead(cfg, blk.path[0])]))


def _tp_bytes(cfg: ModelConfig, n: int, remat: bool) -> int:
    """Bytes one rank hands ``all_reduce`` over ``model`` in the layers of
    one microbatch of n tokens (forward, remat's forward, backward), as
    ``models/parallel.py`` places the psums. Remat's forward stops at the
    unit's last saved tensor, so a psum after it (the unit's last
    ``leave``) runs once."""
    act, d = ACT_BYTES[cfg.dtype], cfg.d_model
    resid = n * d * act
    r = int(remat)
    if cfg.family == "ssm":                     # a layer a unit
        ssm = cfg.ssm or SSMConfig()
        dbc = n * (max(1, d // 16) + 2 * ssm.d_state) * act
        return cfg.num_layers * ((dbc + resid) + r * dbc + (resid + dbc))
    # an attention block: the attention's leave and the MLP's, the first
    # again in remat; backward, the attention's entered inputs and the
    # MLP's
    if cfg.attn_kind == "mla":
        m = cfg.mla or MLAConfig()
        attn_in = n * (m.q_lora_rank + m.kv_lora_rank +
                       m.qk_rope_head_dim) * act
    else:
        attn_in = resid
    mlp_in = resid + (n * (cfg.moe or MoEConfig()).top_k * 4
                      if cfg.family == "moe" else 0)
    block = 2 * resid + r * resid + attn_in + mlp_in
    if cfg.family != "hybrid":
        return cfg.num_layers * block
    # a group: its mixers (the gated norm's float32 sum of squares and
    # the output, both again in remat; backward the input, the sum of
    # squares and the three per-head leaves' grads), then its shared
    # block, whose MLP's leave ends the unit
    ssm = cfg.ssm or SSMConfig(kind="mamba2")
    heads = ssm.expand * d // ssm.headdim
    mixer = (1 + r) * (n * 4 + resid) + resid + n * 4 + 3 * heads * 4
    g, period, _ = T.hybrid_groups(cfg)
    return g * (period * mixer + block)


def _moe_batch_bytes(cfg: ModelConfig, n_call: int, ways: int,
                     remat: bool) -> int:
    """Bytes one rank hands ``all_reduce`` over the batch's ranks in the
    MoE layers of one microbatch: each routing call's per-expert counts
    gathered (the sorted form's int64 counts before the dispatch, the
    grouped form's float32 kept pairs) and its probabilities summed, in
    the forward and remat's."""
    e = (cfg.moe or MoEConfig()).num_experts
    rows = 4 if n_call >= 2 * MOE.GROUP_TOKENS else 8
    return cfg.num_layers * (1 + int(remat)) * (ways * e * rows + e * 4)


def train_collectives(cfg: ModelConfig, tcfg: TrainConfig,
                      param_blocks: List[Block], mesh_shape, mesh_axes,
                      batch_spec) -> Dict[str, Any]:
    """Bytes one rank hands ``all_reduce`` ("all-reduce") and ``broadcast``
    ("all-gather") in one ``make_train_step(mesh=)`` step, counted from
    ``models/parallel.py`` and ``train/trainer.py``: per microbatch each
    layer's leaves gathered over their data axes (a mixer's ``in_proj``
    over every axis) in its forward and in remat's, their grads reduced
    once; over ``model`` the psums of ``_tp_bytes``, the embedding's psum,
    the logits gathered and the unembedding input's psum backward; over
    the batch's ranks the MoE routing calls' sums and, with microbatches,
    the rows re-dealt once; then the replicated leaves' grads summed over
    the batch's axes, the grad norm's and the loss's scalars, and with the
    compressed state each leaf's grad and param gathered whole."""
    sizes = dict(zip(mesh_axes, mesh_shape))
    out = _empty_collectives()
    if int(np.prod(mesh_shape)) == 1:
        return out

    def live(axes):
        return tuple(a for a in mesh_axes if a in axes and sizes[a] > 1)

    def spec_axes(spec):
        return live(sum((SH._entry_axes(e) for e in spec), ()))

    def add(kind, use, nbytes):
        out["all-gather" if kind == "broadcast" else "all-reduce"] += nbytes
        out["by_use"][use] += nbytes

    k = max(tcfg.microbatches, 1)
    batch_axes = spec_axes(batch_spec)
    dw = int(np.prod([sizes[a] for a in batch_axes])) if batch_axes else 1
    m = sizes.get(PAR.MODEL, 1)
    B = tcfg.global_batch if batch_axes == () else tcfg.global_batch // dw
    b, S = B // k, tcfg.seq_len
    act = ACT_BYTES[cfg.dtype]
    remat = cfg.remat
    for blk in param_blocks:
        if blk.path[0] not in ("layers", "shared"):
            continue
        lead = _unit_lead(cfg, blk.path[0])
        axes = spec_axes(PAR.unit_spec(blk.path, blk.spec, lead))
        if not axes:
            continue
        ways = int(np.prod([sizes[a] for a in axes]))
        # the layer's leaf gathered whole over those axes
        whole = _nbytes(blk.local[lead:], blk.dtype) * ways
        uses = _unit_uses(cfg, blk)
        add("broadcast", "gather", k * uses * (1 + remat) * whole)
        add("all_reduce", "scatter", k * uses * whole)
    if m > 1:
        embed = 0 if cfg.frontend != "none" else 1
        add("all_reduce", "psum", k * (_tp_bytes(cfg, b * S, remat) +
                                       (embed + 1) * b * S * cfg.d_model *
                                       act))
        add("broadcast", "logits", k * b * S * cfg.vocab_size * act)
    if dw > 1 and cfg.family == "moe":
        add("all_reduce", "psum",
            k * _moe_batch_bytes(cfg, b * S * dw, dw, remat))
        if k > 1:                       # tokens and labels, int32
            add("broadcast", "batch", 2 * tcfg.global_batch * S * 4)
    if batch_axes:
        gdt = None if k == 1 else torch.float32
        groups: Dict[Tuple, int] = {}
        for blk in param_blocks:
            ax = tuple(a for a in batch_axes if a not in spec_axes(blk.spec))
            if ax:
                key = (ax, gdt or blk.dtype)
                groups[key] = groups.get(key, 0) + \
                    _nbytes(blk.local, gdt or blk.dtype)
        for nbytes in groups.values():
            add("all_reduce", "replicas", nbytes)
        add("all_reduce", "update", 4)                   # the loss
    add("all_reduce", "update", 4)                       # the grad norm
    if tcfg.optimizer.compress_state:
        gdt = None if k == 1 else torch.float32
        for blk in param_blocks:
            if spec_axes(blk.spec):
                add("broadcast", "update",
                    _nbytes(blk.full, gdt or blk.dtype) +
                    _nbytes(blk.full, blk.dtype))
    out["total"] = sum(out[k_] for k_ in COLLECTIVE_KINDS)
    return out


# ---------------------------------------------------------------------------
# Memory (an estimate of the working set) and the HBM floor.
# ---------------------------------------------------------------------------

def _model_only(spec) -> Tuple:
    """``spec`` with only its ``model`` axis kept: a layer's leaf as the
    mesh step gathers it (whole over data, the rank's block over model)."""
    return tuple(PAR.MODEL if PAR.MODEL in SH._entry_axes(e) else None
                 for e in spec)


def gathered_bytes(param_blocks: List[Block], sizes: Dict[str, int],
                   whole: bool = False) -> int:
    """Bytes of the params as the rank's products read them: each leaf
    gathered over its data axes, the rank's block over ``model``; with
    ``whole``, as a layer gathers them (a mixer's ``in_proj`` whole over
    ``model`` too: ``models/parallel.py::WHOLE``)."""
    def spec(b):
        return () if whole and tuple(b.path[-2:]) in PAR.WHOLE else \
            _model_only(b.spec)
    return sum(_nbytes(SH.block_shape(b.full, spec(b), sizes), b.dtype)
               for b in param_blocks if b.full)


# bytes autograd saves a token a d_in channel of one mixer's forward, as
# (a, b): a + b x the activation's bytes (the tensors its saved-tensor
# hooks see at the published widths; tests/test_torch_train_ssm.py holds
# the count to them)
MIXER_SAVED = {"mamba1": (32.5, 2), "mamba2": (36, 3)}
# [B, chunk, ..., N] float32 tensors one chunk's backward holds at once
# (``_ScanChunk``: the recomputed states, their gradient, the reverse
# scan's two buffers, the shifted decay and the decay's gradient; Mamba2's
# decay is one value a head, so two fewer)
SCAN_BACKWARD_LIVE = {"mamba1": 6, "mamba2": 4}


def unit_working_set(cfg: ModelConfig, rows: int, seq: int,
                     grad: bool) -> int:
    """Bytes one remat unit holds while it runs (an estimate): with
    ``grad``, its recomputed activations and B6's PyTorch backward (float32
    keys and values expanded to every head, their grads, and the scores,
    probabilities and their grad of a 512-row chunk); each mixer's saved
    tensors (``MIXER_SAVED``) and the state before each scan chunk, and
    one chunk's backward (``SCAN_BACKWARD_LIVE``; no pass of the scan is
    kept past its chunk); without, the scan's float32 chunk tensors."""
    n, d, act = rows * seq, cfg.d_model, ACT_BYTES[cfg.dtype]
    out = 0
    if cfg.attn_kind != "none":
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        if cfg.family == "moe":
            mo = cfg.moe or MoEConfig()
            mlp = moe_rows(cfg, n) * (d + 3 * mo.expert_d_ff) * act + \
                n * mo.top_k * d * act
        else:
            mlp = 3 * n * cfg.d_ff * act
        out += n * (4 * d + 2 * (hq + hkv) * hd) * act + mlp
        if grad:
            c = min(512, seq)
            out += 4 * rows * hq * seq * (5 * hd + 3 * c)
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm or SSMConfig()
        d_in = ssm.expand * d
        c = min(ssm.chunk, seq)
        state = rows * d_in * ssm.d_state * 4
        per = c * state
        period = T.hybrid_groups(cfg)[1] if cfg.family == "hybrid" else 1
        if grad:
            a, b = MIXER_SAVED[ssm.kind]
            out += period * (n * d_in * (a + b * act) +
                             max(seq // c, 1) * state) + \
                SCAN_BACKWARD_LIVE[ssm.kind] * per
        else:
            out += period * (5 * per + n * 4 * d_in * act)
    return int(out)


def train_memory(cfg: ModelConfig, tcfg: TrainConfig, param_blocks,
                 state_b: int, batch_b: int, rows: int,
                 sizes: Dict[str, int]) -> Dict[str, Any]:
    """A rank's bytes in one train step: params, grads (the params' dtype;
    with microbatches also the float32 sum), state, batch, and ``temp``, an
    estimate of the working set: the saved layer inputs under remat (every
    unit's working set without it), then the larger of one unit's working
    set (with the layer's gathered leaves and their grads on a mesh) and the
    logits' (the loss's float32 log-softmax, its incoming grad and its
    grad: 12 B a logit). ``rows``: the rank's rows of the batch."""
    k = max(tcfg.microbatches, 1)
    b, S, act = rows // k, tcfg.seq_len, ACT_BYTES[cfg.dtype]
    params = total_bytes(param_blocks)
    numel = sum(bl.numel for bl in param_blocks)
    grads = params + (4 * numel if k > 1 else 0)
    units = remat_unit_count(cfg)
    unit = unit_working_set(cfg, b, S, grad=True)
    # the layer's leaves that its forward gathers (a live axis in the
    # spec it gathers them under), and their grads
    gathered = 2 * gathered_bytes([
        bl for bl in param_blocks if bl.path[0] in ("layers", "shared") and
        any(sizes[a] > 1 for e in PAR.unit_spec(
            bl.path, bl.spec, _unit_lead(cfg, bl.path[0]))
            for a in SH._entry_axes(e))], sizes, whole=True) // max(units, 1)
    saved = units * b * S * cfg.d_model * act if cfg.remat else \
        units * unit
    temp = saved + max(unit + gathered, 12 * b * S * cfg.vocab_size)
    return {"params": params, "grads": grads, "state": state_b,
            "batch": batch_b, "temp": int(temp),
            "peak": int(params + grads + state_b + batch_b + temp)}


def train_hbm_floor(cfg: ModelConfig, tcfg: TrainConfig, param_blocks,
                    state_b: int, rows: int, sizes: Dict[str, int]) -> int:
    """The module docstring's floor of HBM bytes of one train step: the
    params (gathered as the products read them) read by the forward,
    remat's forward and the backward a microbatch, the grads written a
    microbatch; the rank's own params and grads read by the norm and the
    update and the params written; the state read and written; the saved
    layer inputs and the logits and their grad written and read."""
    k = max(tcfg.microbatches, 1)
    b, S, act = rows // k, tcfg.seq_len, ACT_BYTES[cfg.dtype]
    local, gath = total_bytes(param_blocks), gathered_bytes(param_blocks,
                                                            sizes)
    units = remat_unit_count(cfg)
    passes = k * (3 + int(cfg.remat)) * gath      # + the grads' writes
    update = 4 * local + 2 * state_b
    acts = k * 2 * b * S * act * (units * cfg.d_model + 2 * cfg.vocab_size)
    return int(passes + update + acts)


def serve_hbm_floor(cfg: ModelConfig, kind: str, rows: int, seq: int,
                    gathered: int, cache: int, logits: int) -> int:
    """A floor of HBM bytes of a serve step: the params read once and the
    cache written (prefill) or read (decode) once, the logits written;
    prefill also writes and reads each block's input."""
    out = gathered + cache + logits
    if kind == "prefill":
        out += 2 * remat_unit_count(cfg) * rows * seq * cfg.d_model * \
            ACT_BYTES[cfg.dtype]
    return int(out)


def serve_memory(cfg: ModelConfig, kind: str, rows: int, seq: int,
                 params: int, cache: int, inputs: int,
                 scfg: ServeConfig) -> Dict[str, Any]:
    """A rank's bytes in a prefill (``seq`` prompt tokens) or decode step
    (a cache of ``seq`` positions): params, cache, inputs, the logits, and
    ``temp``, an estimate: one layer's working set (prefill), or one
    lane's layer of activations and the ring's float32 copies (decode)."""
    act = ACT_BYTES[cfg.dtype]
    logits = rows * cfg.vocab_size * act
    if kind == "prefill":
        temp = unit_working_set(cfg, rows, seq, grad=False) + \
            2 * rows * seq * cfg.d_model * act
    else:
        temp = rows * (6 * cfg.d_model + 3 * max(cfg.d_ff, 1)) * act
        if cfg.attn_kind != "none":
            temp += 2 * rows * scfg.hot_window * cfg.num_kv_heads * \
                cfg.resolved_head_dim * 4
    return {"params": params, "cache": cache, "inputs": inputs,
            "logits": logits, "temp": int(temp),
            "peak": int(params + cache + inputs + logits + temp)}
