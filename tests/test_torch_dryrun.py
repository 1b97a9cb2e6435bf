"""The port's dry run (``launch/dryrun.py``, ``roofline/count.py``) against
the JAX package and against the port itself, on the CPU:

  * ``models/decode.py::cache_axes`` equals the reference's tree for all
    10 arch ids;
  * the per-rank argument bytes of every (arch x shape) cell on the
    production meshes (16, 16) and (2, 16, 16) and on ``plan_mesh(n,
    prefer_model=2)`` for n in 1, 2, 4, 8 equal the sum of the reference's
    shard shapes: the reference's ``input_specs`` (its params, AdamW state
    and batch; the KV cache from ``init_cache`` under ``eval_shape``)
    under its ``rules_for`` and ``logical_to_spec``, each shard at the
    port's storage type (the reference keeps float32 params and casts them
    at use; the port stores ``cfg.dtype``); a cell with a dim that does
    not split evenly fails in both;
  * the count's matmul FLOPs equal ``FlopCounterMode`` on the port's
    REDUCED train step on the plain route, one case per family (dense,
    MLA, MoE in both dispatch forms, SSM, hybrid) and one at 2
    microbatches, and its float32 part equals the same formulas summed
    over the products whose operands are float32; on the kernel route the
    float32 part is B6's PyTorch backward, as ``FlopCounterMode`` counts
    ``flash_attention_backward``;
  * the count's collective bytes equal the bytes ``Mesh``'s collectives
    hand ``all_reduce`` and ``broadcast`` in one REDUCED llama3 step on
    gloo ranks at (2, 1), (1, 2) and (2, 2) (the raw state; at (2, 2) also
    the compressed state and 2 microbatches), and at (2, 1) and (1, 2) in
    one step of each other kind (MLA, MoE at 2 microbatches, Mamba1,
    hybrid), counted by wrapping the two calls
    (``tests/torch_dryrun_ranks.py``);
  * the per-device ``memory_analysis().argument_size_in_bytes`` of the
    reference's compiled REDUCED train step on a (2, 2) mesh of 4 forced
    host devices (a subprocess, beside the ranks) equals the port's
    argument bytes.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

jax = pytest.importorskip("jax")

from repro.common import sharding as JSH  # noqa: E402
from repro.common.types import SHAPES_BY_NAME as JSHAPES  # noqa: E402
from repro.common.types import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as JDRY  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro_torch.common import sharding as SH  # noqa: E402
from repro_torch.common import tree as TR  # noqa: E402
from repro_torch.common.types import (ALL_SHAPES, MeshConfig,  # noqa: E402
                                      OptimizerConfig, ServeConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import elastic, trainer  # noqa: E402

MESHES = [MeshConfig((16, 16), ("data", "model")),
          MeshConfig((2, 16, 16), ("pod", "data", "model"))] + \
    [elastic.plan_mesh(n, prefer_model=2) for n in (1, 2, 4, 8)]
RANK_MESHES = [(2, 1), (1, 2), (2, 2)]
# one config of each other kind beside llama3 at (2, 1) and (1, 2): MLA,
# MoE (at 2 microbatches: its rows re-dealt over data), Mamba1, hybrid
FAMILY_MOE = "qwen3_moe_235b_a22b"
RANK_FAMILIES = ("minicpm3_4b", FAMILY_MOE, "falcon_mamba_7b", "zamba2_2p7b")
RANK_TIMEOUT = 300.0
SRC = Path(__file__).resolve().parents[1] / "src"
# the XLA subprocess's cell: REDUCED llama3 in float32 at 16 x 32 tokens
XLA_SHAPE = ("train_reduced", 32, 16, "train")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_equal_reference(arch):
    scfg = ServeConfig()
    assert D.cache_axes(get_config(arch), scfg) == JD.cache_axes(
        jget_config(arch), JDRY.serve_cfg_for(jget_config(arch),
                                              JSHAPES["decode_32k"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_axes_key_init_cache(arch):
    """``leaf_axes`` names every leaf of ``init_cache`` with as many axes
    as it has dims."""
    cfg = get_config(arch)
    cache = D.init_cache(cfg, ServeConfig(), 2, 64, "meta")
    axes = D.leaf_axes(cfg, ServeConfig())
    assert sorted(cache) == sorted(axes)
    assert all(len(axes[k]) == cache[k].dim() for k in cache)


# ---------------------------------------------------------------------------
# Per-rank argument bytes against the reference's shard shapes.
# ---------------------------------------------------------------------------

def _shard_numel(shape, spec, sizes):
    """Elements of one device's shard, or None where a dim does not split
    evenly (the reference's lowering refuses such an argument)."""
    n = 1
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        ways = int(np.prod([sizes[a] for a in SH._entry_axes(e)]))
        if dim % ways:
            return None
        n *= dim // ways
    return n


def _ref_bytes(leaves, sizes):
    """Sum over (shape, spec, itemsize) leaves; None if one fails."""
    total = 0
    for shape, spec, item in leaves:
        n = _shard_numel(shape, spec, sizes)
        if n is None:
            return None
        total += n * item
    return total


@pytest.fixture(scope="module")
def ref_specs():
    """{arch: (the reference's abstract params, axes)}, once."""
    return {a: JDRY.abstract_params(jget_config(a)) for a in ARCH_IDS}


def _reference_argument_bytes(arch, shape, mc, ref):
    """The reference's per-device argument bytes of the cell by kind, or
    None where a dim does not split."""
    jcfg, jshape = jget_config(arch), JSHAPES[shape.name]
    sizes = dict(zip(mc.axes, mc.shape))
    rules = JM.rules_for(jshape, mc.axes, jcfg, sizes.get("model", 1))

    def spec(axes):
        return tuple(JSH.logical_to_spec(axes, rules, mc.axes))

    port_params = {"/".join(map(str, p)): x for p, x in
                   TR.leaves_with_paths(DRY.abstract_params(
                       get_config(arch))[0])}
    shapes, axes = ref
    ax = {_key(p): a for p, a in jax.tree_util.tree_leaves_with_path(
        axes, is_leaf=_is_axes)}
    params = [(x.shape, spec(ax[_key(p)]),
               port_params[_key(p)].element_size())
              for p, x in jax.tree_util.tree_leaves_with_path(shapes)]
    B, S = jshape.global_batch, jshape.seq_len
    out = {"params": params}
    rows = [((B, S), spec(("batch", "seq")), 4)]
    embeds = [((B, S, jcfg.d_model), spec(("batch", "seq", "embed")), 2)] \
        if jcfg.frontend != "none" else []
    if jshape.kind == "train":
        opt = jax.eval_shape(lambda: JDRY.adamw.init(
            shapes, JDRY.train_cfg_for(jcfg, jshape).optimizer))
        out["state"] = [((), (), 4)] + [
            (x.shape, spec(ax[_key(p)]), x.dtype.itemsize)
            for tree in (opt.m, opt.v)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]
        out["batch"] = 2 * rows + embeds
    elif jshape.kind == "prefill":
        out["inputs"] = rows + embeds
    else:
        scfg = JDRY.serve_cfg_for(jcfg, jshape)
        cache = jax.eval_shape(lambda: JD.init_cache(jcfg, scfg, B, S))
        cax = {_key(p): a for p, a in jax.tree_util.tree_leaves_with_path(
            JD.cache_axes(jcfg, scfg), is_leaf=_is_axes)}
        out["cache"] = [(x.shape, spec(cax[_key(p)]), x.dtype.itemsize)
                        for p, x in jax.tree_util.tree_leaves_with_path(
                            cache)]
        out["inputs"] = [((B,), spec(("batch",)), 4)] * 2 + (
            [((B, jcfg.d_model), spec(("batch", "embed")), 2)]
            if jcfg.frontend != "none" else [])
    return {k: _ref_bytes(v, sizes) for k, v in out.items()}


@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_reference_shards(ref_specs, arch, shape):
    cfg = get_config(arch)
    sh = next(s for s in ALL_SHAPES if s.name == shape)
    if not DRY.applicable(cfg, sh)[0]:
        assert not JDRY.applicable(jget_config(arch), JSHAPES[shape])[0]
        return
    n = 0
    for mc in MESHES:
        want = _reference_argument_bytes(arch, sh, mc, ref_specs[arch])
        if any(v is None for v in want.values()):
            with pytest.raises(ValueError, match="does not split"):
                DRY.count_cell(cfg, sh, mc)
            continue
        rec = DRY.count_cell(cfg, sh, mc)
        got = rec["per_rank"]
        for kind, v in want.items():
            assert got[kind] == v, (mc.shape, kind)
        assert rec["memory"]["argument_bytes"] == sum(want.values())
        n += 1
    assert n == len(MESHES)          # every cell splits on every mesh


# ---------------------------------------------------------------------------
# FLOPs against FlopCounterMode.
# ---------------------------------------------------------------------------

FLOP_CASES = [("llama3_8b", 4, 64, 1), ("minicpm3_4b", 4, 64, 1),
              ("qwen3_moe_235b_a22b", 4, 64, 1),
              ("qwen3_moe_235b_a22b", 8, 256, 1),   # the grouped dispatch
              ("falcon_mamba_7b", 4, 64, 1), ("zamba2_2p7b", 4, 64, 1),
              ("llama3_8b", 4, 64, 2)]


class _F32Flops(TorchDispatchMode):
    """``FlopCounterMode``'s formulas summed over the products whose
    operands are float32."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and next(
                a for a in args if isinstance(a, torch.Tensor)).dtype == \
                torch.float32:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


@pytest.mark.parametrize("case", FLOP_CASES,
                         ids=lambda c: "%s-%dx%d-mb%d" % c)
def test_matmul_flops_equal_flop_counter(case):
    arch, B, S, k = case
    cfg = get_reduced(arch)
    tcfg = TrainConfig(seq_len=S, global_batch=B, microbatches=k)
    p = trainer.init_params(cfg, 0, "cpu")
    opt = adamw.init(p, tcfg.optimizer)
    step = trainer.make_train_step(cfg, tcfg)[0]
    batch = make_batch(cfg, 0, global_batch=B, seq_len=S, device="cpu")
    fc, f32 = FlopCounterMode(display=False), _F32Flops()
    with fc, f32:
        step(p, opt, batch)
    rec = DRY.count_cell(cfg, ShapeConfig("reduced", S, B, "train"),
                         MeshConfig((1, 1)), tcfg, route="plain")
    assert rec["flops"] == fc.get_total_flops()
    assert 0 < rec["flops_f32"] < rec["flops"]
    assert rec["flops_f32"] == f32.flops


@pytest.mark.parametrize("arch", ["llama3_8b", "zamba2_2p7b"])
def test_kernel_route_f32_flops_are_b6_backward(arch):
    """On the card the float32 products of a bf16 model's train step are
    B6's PyTorch backward (``flash_attention_backward``, five products
    over every key: FlopCounterMode's count of it at the step's shape)
    and the SSM scans' contraction (forward, remat's forward, the chunk
    backward's recompute and its two products); a float32 model's are all
    of them."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.roofline import count as C
    cfg = get_reduced(arch)
    B, S = 2, 64
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(0)
    q, o, do = (torch.randn((B, S, hq, hd), generator=gen,
                            dtype=torch.bfloat16) for _ in range(3))
    k, v = (torch.randn((B, S, hkv, hd), generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    fc = FlopCounterMode(display=False)
    with fc:
        FA.flash_attention_backward(q, k, v, o, do, causal=True,
                                    sm_scale=hd ** -0.5)
    sites = C._sites(cfg)
    scan = C.train_matmul_flops(cfg, B, S, "kernel", f32=True) - \
        sites * fc.get_total_flops()
    contract = sum(f for n, f in C._mamba(cfg, B, S) if n == "ssm_contract")
    assert scan == (0 if cfg.family != "hybrid" else
                    cfg.num_layers * contract * (4 + int(cfg.remat)))
    f32 = dataclasses.replace(cfg, dtype="float32")
    assert C.train_matmul_flops(f32, B, S, "kernel", f32=True) == \
        C.train_matmul_flops(f32, B, S, "kernel")


def test_kernel_route_counts_causal_forward_and_full_backward():
    """On the card B6's forward counts the causal pairs and its backward
    five products over every key; the plain route two and four."""
    from repro_torch.roofline import count as C
    fwd, bwd = C._attention(8, 512, 512, 32, 128, 128, "kernel")
    pairs = 512 * 513 // 2
    assert [f for _, f in fwd] == [2 * 8 * 32 * pairs * 128] * 2
    assert bwd == 2 * 8 * 32 * 512 * 512 * 5 * 128
    fwd, bwd = C._attention(8, 512, 512, 32, 128, 128, "plain")
    assert bwd == 2 * sum(f for _, f in fwd)


# peak bytes the dry run counted for these train_512 cells on one device
# before the SSM scan kept only one chunk's passes for the backward
PEAK_BEFORE_CHUNK_SCAN = {"zamba2_2p7b": 565_448_255_612,
                          "falcon_mamba_7b": 82_721_034_412}


@pytest.mark.parametrize("arch,fits", [
    ("zamba2_2p7b", True), ("falcon_mamba_7b", True), ("minicpm3_4b", True),
    ("qwen3_moe_235b_a22b", False)])
def test_one_card_train_512_fits(arch, fits, tmp_path):
    """``dryrun --arch A --shape train_512 --devices 1``: the SSM and
    hybrid steps fit one H100 now that the scan's backward keeps one
    chunk (zamba2-2.7b counted 565 GB before, falcon-mamba-7b 82.7 GB of
    the card's 85.0); qwen3-moe's 235B params do not."""
    from repro_torch.roofline import analyze as RA
    rec = DRY.run_cell(arch, "train_512", False, str(tmp_path), devices=1)
    assert rec["cell"] == f"{arch}__train_512__d1" and rec["status"] == "ok"
    assert rec["fits"] is fits
    assert rec["device_memory"] == RA.HBM_BYTES
    if arch in PEAK_BEFORE_CHUNK_SCAN:
        assert rec["peak_bytes"] < 0.7 * PEAK_BEFORE_CHUNK_SCAN[arch]


# ---------------------------------------------------------------------------
# Collective bytes on gloo ranks; the reference's XLA argument bytes.
# ---------------------------------------------------------------------------

def _xla_argument_bytes(out_path: str) -> None:
    """In a subprocess with 4 forced host devices: the reference's REDUCED
    float32 llama3 train step lowered on a (2, 2) mesh and compiled; its
    per-device argument bytes written to ``out_path``."""
    from jax.sharding import Mesh
    from repro.configs import get_reduced as jget_reduced
    jcfg = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    with mesh:
        fn, args = JDRY.make_train_lowerable(jcfg, JShape(*XLA_SHAPE), mesh)
        mem = fn.lower(*args).compile().memory_analysis()
    Path(out_path).write_text(str(mem.argument_size_in_bytes))


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    import concurrent.futures as cf
    import torch_dryrun_ranks
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    sub = subprocess.Popen([sys.executable, __file__, str(tmp / "xla")],
                           env=env)
    def f32(arch):
        return dataclasses.replace(get_reduced(arch), dtype="float32")

    cfg = f32("llama3_8b")
    raw = TrainConfig(seq_len=32, global_batch=4)
    more = [TrainConfig(seq_len=32, global_batch=4, optimizer=OptimizerConfig(
        compress_state=True)), TrainConfig(seq_len=32, global_batch=8,
                                           microbatches=2)]
    families = [(f32(a), TrainConfig(seq_len=32, global_batch=8,
                                     microbatches=2) if a == FAMILY_MOE
                 else raw) for a in RANK_FAMILIES]
    runs = {s: [(cfg, raw)] + ([(cfg, t) for t in more] if s == (2, 2)
                               else families) for s in RANK_MESHES}
    try:
        with cf.ThreadPoolExecutor(3) as pool:
            futs = {s: pool.submit(
                SH.spawn_ranks, torch_dryrun_ranks.collective_bytes,
                s[0] * s[1], backend="gloo", args=(runs[s], s),
                device="cpu", workdir=str(tmp / ("%dx%d" % s)),
                timeout=RANK_TIMEOUT) for s in RANK_MESHES}
            got = {s: f.result() for s, f in futs.items()}
        assert sub.wait(timeout=RANK_TIMEOUT) == 0
    finally:
        if sub.poll() is None:
            sub.kill()
    return {"cfg": cfg, "runs": runs, "ranks": got,
            "xla": int((tmp / "xla").read_text())}


@pytest.mark.parametrize("shape", RANK_MESHES, ids=lambda s: "%dx%d" % s)
def test_collective_bytes_equal_gloo_ranks(rank_runs, shape):
    mc = MeshConfig(shape, ("data", "model"))
    runs = rank_runs["runs"][shape]
    assert len(runs) == (3 if shape == (2, 2) else 1 + len(RANK_FAMILIES))
    for i, per_rank in enumerate(zip(*rank_runs["ranks"][shape])):
        cfg, tcfg = runs[i]
        want = DRY.count_cell(cfg, ShapeConfig(
            "reduced", tcfg.seq_len, tcfg.global_batch, "train"), mc,
            tcfg)["collective_bytes"]
        assert len(per_rank) == shape[0] * shape[1]
        for tally in per_rank:
            assert (tally["all_reduce"], tally["broadcast"]) == \
                (want["all-reduce"], want["all-gather"]), (i, tally, want)
            assert tally["all_reduce"] > 0 and tally["broadcast"] >= 0


def test_argument_bytes_equal_xla_memory_analysis(rank_runs):
    """The reference's compiled step holds, per device, what the port's
    count says a rank holds: params, the raw AdamW state, the batch."""
    cfg = rank_runs["cfg"]
    rec = DRY.count_cell(cfg, ShapeConfig(*XLA_SHAPE),
                         MeshConfig((2, 2), ("data", "model")))
    assert rec["memory"]["argument_bytes"] == rank_runs["xla"]


if __name__ == "__main__":
    _xla_argument_bytes(sys.argv[1])
