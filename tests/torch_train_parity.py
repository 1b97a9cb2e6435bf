"""Shared checks of the port's train step against the reference's for one
arch's REDUCED config in float32 (``test_torch_train_families.py``,
``test_torch_train_ssm.py``): the reference's ``init_params(PRNGKey(0))``
carried across in the stacked layout (``interop``), the same
``make_batch`` batches through both packages, and
``test_torch_train.py``'s tolerances:

  * the loss at rtol 1e-5, every grad leaf normwise 1e-4, microbatches 1
    and 2 (``grads_and_loss``);
  * three ``make_train_step`` steps (microbatches 2) against the
    reference's jitted step (``ref_steps``, run once an arch): losses at
    rtol 1e-5, params normwise 1e-4;
  * the same three steps on (data, model) meshes of gloo ranks
    (``mesh_runs``, ``check_mesh``) against the same reference: GSPMD
    keeps the one-device program's meaning, so the one-device step is
    the mesh step's oracle up to the order of float32 sums; losses and
    grad norms at rtol 1e-5, params and raw moments normwise 1e-4;
  * the compressed state (``compress_state=True``) against the reference's
    grads (jitted) and its eager update, each step fed the reference's params and
    state: losses at rtol 1e-5, params normwise 1e-4, the 8-bit codes of m
    and sqrt(v) equal but for codes one apart at a rounding boundary,
    under 1 in 1,000, the scales within 1e-4 relative (C11: the
    reference's jitted compressed step cannot run).
"""
import concurrent.futures as cf
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.common.types import OptimizerConfig as JOpt
from repro.common.types import TrainConfig as JTrain
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import trainer as JTR
from repro_torch import interop
from repro_torch.common import sharding as SH
from repro_torch.common import tree as TR
from repro_torch.common.types import OptimizerConfig, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.configs.registry import ALIASES
from repro_torch.data.pipeline import make_batch
from repro_torch.optim import adamw
from repro_torch.train import trainer

GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
MAX_CODE_FLIPS = 1e-3
BATCH, SEQ = 4, 32
MESHES = [(2, 1), (1, 2), (2, 2)]
RANK_TIMEOUT = 300.0


def norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    """(port config, reference config, the reference's params as numpy),
    both configs REDUCED in float32 and equal field for field; the params
    from the reference's ``init_params`` under ``jax.jit`` (one compile;
    both packages start from these same arrays)."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: JT.init_params(key, jcfg)[0])(jax.random.PRNGKey(0)))
    return cfg, jcfg, jparams


def params(cfg, jparams):
    return interop.stacked_params_from_numpy(jparams, cfg, device="cpu")


def jbatch(jcfg, step=0):
    return jmake_batch(jcfg, step, global_batch=BATCH, seq_len=SEQ)


def batch(cfg, step=0):
    return make_batch(cfg, step, global_batch=BATCH, seq_len=SEQ,
                      device="cpu")


@functools.lru_cache(maxsize=None)
def jgrads(jcfg, microbatches: int = 1):
    """The reference's ``grads_and_loss`` under ``jax.jit`` (its values,
    one compile a config instead of an eager run's many small ones)."""
    return jax.jit(lambda p, b: JTR.grads_and_loss(p, b, jcfg, microbatches))


def check_grads(cfg, jcfg, jparams, microbatches: int) -> int:
    """``grads_and_loss`` against the reference's; the number of leaves."""
    jg, jl = jgrads(jcfg, microbatches)(jparams, jbatch(jcfg))
    g, loss = trainer.grads_and_loss(params(cfg, jparams), batch(cfg), cfg,
                                     microbatches)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = dict(TR.leaves_with_paths(jg))
    got = dict(TR.leaves_with_paths(g))
    assert set(got) == set(want)
    for path, x in got.items():
        assert tuple(x.shape) == want[path].shape, path
        assert norm_err(x, want[path]) <= GRAD_TOL, path
    return len(got)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_cfgs(steps=3, global_batch=BATCH, seq_len=SEQ, microbatches=2):
    """(the reference's TrainConfig, the port's): lr 1e-3, warm-up 1."""
    kw = dict(steps=steps, seq_len=seq_len, global_batch=global_batch,
              microbatches=microbatches)
    return (JTrain(optimizer=JOpt(lr=1e-3, warmup_steps=1), **kw),
            TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1),
                        **kw))


def np_batches(jcfg, steps, global_batch=BATCH, seq_len=SEQ):
    return [{k: np.asarray(v) for k, v in jmake_batch(
        jcfg, i, global_batch=global_batch, seq_len=seq_len).items()}
        for i in range(steps)]


@functools.lru_cache(maxsize=None)
def ref_steps(arch: str, steps=3, global_batch=BATCH, seq_len=SEQ,
              microbatches=2) -> dict:
    """The reference's jitted step from its ``init_params``, ``steps``
    times over ``make_batch``'s batches: losses, grad norms, and the end
    params and raw moments as numpy (one run an arch and recipe, shared
    by the one-device and the mesh checks)."""
    _, jcfg, jparams = setup(arch)
    jt = train_cfgs(steps, global_batch, seq_len, microbatches)[0]
    jstep, _ = JTR.make_train_step(jcfg, jt)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jopt = JA.init(jp, jt.optimizer)
    losses, norms = [], []
    for b in np_batches(jcfg, steps, global_batch, seq_len):
        jp, jopt, jm = jstep(jp, jopt, b)
        losses.append(float(jm["loss"]))
        norms.append(float(jm["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "params": _np(jp),
            "m": _np(jopt.m), "v": _np(jopt.v)}


def check_three_steps(cfg, jcfg, jparams) -> list:
    """Three steps (microbatches 2) against the reference's jitted step;
    the port's losses."""
    ref = ref_steps(ALIASES[cfg.name])
    tcfg = train_cfgs()[1]
    step, _ = trainer.make_train_step(cfg, tcfg)
    p = params(cfg, jparams)
    opt = adamw.init(p, tcfg.optimizer)
    losses = []
    for i in range(3):
        p, opt, m = step(p, opt, batch(cfg, i))
        np.testing.assert_allclose(float(m["loss"]), ref["losses"][i],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref["grad_norms"][i], rtol=GRAD_TOL)
        losses.append(float(m["loss"]))
    want = dict(TR.leaves_with_paths(ref["params"]))
    for path, x in TR.leaves_with_paths(p):
        assert norm_err(x, want[path]) <= GRAD_TOL, path
    return losses


def mesh_runs(archs, tmp, extra=None) -> dict:
    """Each arch's three steps (``ref_steps``' recipe) on each mesh of
    MESHES over gloo ranks: one spawn a mesh, side by side, each running
    the archs in turn (``torch_mesh_ranks.mesh_steps``), the reference's
    runs made meanwhile. ``extra``: {shape: [(key, arch, TrainConfig,
    global batch, seq len, enter_input)]} run after the archs on that
    mesh. Returns {(arch or key, shape): rank 0's record}."""
    import torch_mesh_ranks
    jobs = {s: [(a, a, train_cfgs()[1], BATCH, SEQ, False) for a in archs]
            + list((extra or {}).get(s, ())) for s in MESHES}

    def run(shape):
        runs = []
        for _, arch, tcfg, gb, seq, enter in jobs[shape]:
            cfg, jcfg, jparams = setup(arch)
            runs.append((cfg, tcfg, jparams,
                         np_batches(jcfg, tcfg.steps, gb, seq), enter))
        return SH.spawn_ranks(
            torch_mesh_ranks.mesh_steps, shape[0] * shape[1],
            backend="gloo", args=(shape, runs), device="cpu",
            workdir=str(tmp / ("%dx%d" % shape)), timeout=RANK_TIMEOUT)[0]

    for arch in archs:
        setup(arch)
    with cf.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {s: pool.submit(run, s) for s in MESHES}
        for arch in archs:
            ref_steps(arch)
        return {(key, s): rec for s, f in futs.items()
                for (key, *_), rec in zip(jobs[s], f.result())}


def check_mesh(got: dict, ref: dict) -> dict:
    """A mesh run against the reference's steps: losses and grad norms at
    rtol LOSS_RTOL, every param and raw moment normwise GRAD_TOL; the
    largest errors."""
    errs = {}
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[key], ref[key], rtol=LOSS_RTOL)
        errs[key] = max(abs(a - b) / abs(b) for a, b in zip(got[key],
                                                            ref[key]))
    n = 0
    for name, tree in (("params", got["params"]), ("m", got["opt"].m),
                       ("v", got["opt"].v)):
        want = dict(TR.leaves_with_paths(ref[name]))
        assert {p for p, _ in TR.leaves_with_paths(tree)} == set(want)
        errs[name] = 0.0
        for path, x in TR.leaves_with_paths(tree):
            assert x.shape == want[path].shape, (name, path)
            e = norm_err(x, want[path])
            assert e <= GRAD_TOL, (name, path, e)
            errs[name] = max(errs[name], e)
            n += 1
    errs["leaves"] = n
    return errs


def assert_codes_close(got_state, want_state, what, scale_rtol):
    """Codes equal but for flips of one at a rounding boundary, under
    MAX_CODE_FLIPS of them; blocks equal; scales within ``scale_rtol``."""
    flips = total = 0
    for tree_g, tree_w in ((got_state.m, want_state.m),
                           (got_state.v, want_state.v)):
        want = dict(TR.leaves_with_paths(jax.tree_util.tree_map(
            np.asarray, tree_w)))
        for path, x in TR.leaves_with_paths(tree_g):
            w = want[path]
            if path[-1] == "block":
                assert x == int(w), path
            elif path[-1] == "codes":
                d = np.abs(x.numpy().view(np.int8).astype(np.int32) -
                           w.view(np.int8).astype(np.int32))
                assert d.max() <= 1, (what, path, d.max())
                flips += int((d > 0).sum())
                total += d.size
            else:
                np.testing.assert_allclose(x.numpy(), w, rtol=scale_rtol,
                                           err_msg=str(path))
    assert flips <= MAX_CODE_FLIPS * total, (what, flips, total)
    return flips, total


def check_compressed_steps(cfg, jcfg, jparams, steps: int = 2):
    """The port's compressed step against the reference's grads and eager
    update, step by step from the reference's params and state; the
    blocks of the state (leaf path -> block) and (flips, codes). The
    initial state is the port's ``adamw.init`` (all-zero codes and scales,
    equal to the reference's ``init``: ``test_torch_train.py``), each
    leaf's block held to the reference's rule ``_blk``."""
    ocfg = JOpt(lr=1e-3, warmup_steps=1, compress_state=True)
    tcfg = TrainConfig(seq_len=SEQ, global_batch=BATCH,
                       optimizer=OptimizerConfig(**dataclasses.asdict(ocfg)))
    step, _ = trainer.make_train_step(cfg, tcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    init = interop.opt_state_to_numpy(adamw.init(params(cfg, jparams),
                                                 tcfg.optimizer))
    sizes = dict(TR.leaves_with_paths(jparams))
    for path, b in TR.leaves_with_paths(init.m):
        if path[-1] == "block":
            assert int(b) == JA._blk(sizes[path[:-1]].size,
                                     ocfg.state_block), path
    jopt = JA.AdamState(jnp.int32(0), *(jax.tree_util.tree_map(
        jnp.asarray, t) for t in (init.m, init.v)))
    flips = total = 0
    grads = jgrads(jcfg)
    for i in range(steps):
        p = params(cfg, jax.tree_util.tree_map(np.asarray, jp))
        opt = interop.opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt), device="cpu")
        g, jl = grads(jp, jbatch(jcfg, i))
        jp, jopt, _ = JA.update(g, jopt, jp, ocfg)
        p, opt, m = step(p, opt, batch(cfg, i))
        np.testing.assert_allclose(float(m["loss"]), float(jl),
                                   rtol=LOSS_RTOL)
        want = dict(TR.leaves_with_paths(jp))
        for path, x in TR.leaves_with_paths(p):
            assert norm_err(x, want[path]) <= GRAD_TOL, path
        f, t = assert_codes_close(opt, jopt, f"step {i}", GRAD_TOL)
        flips, total = flips + f, total + t
    blocks = {"/".join(path[:-1]): b for path, b in
              TR.leaves_with_paths(opt.m) if path[-1] == "block"}
    return blocks, (flips, total)
