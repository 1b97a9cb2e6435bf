"""Shared checks of the port's train step against the reference's for one
arch's REDUCED config in float32 (``test_torch_train_families.py``,
``test_torch_train_ssm.py``): the reference's ``init_params(PRNGKey(0))``
carried across in the stacked layout (``interop``), the same
``make_batch`` batches through both packages, and
``test_torch_train.py``'s tolerances:

  * the loss at rtol 1e-5, every grad leaf normwise 1e-4, microbatches 1
    and 2 (``grads_and_loss``);
  * three ``make_train_step`` steps (microbatches 2) against the
    reference's jitted step: losses at rtol 1e-5, params normwise 1e-4;
  * the compressed state (``compress_state=True``) against the reference's
    grads (jitted) and its eager update, each step fed the reference's params and
    state: losses at rtol 1e-5, params normwise 1e-4, the 8-bit codes of m
    and sqrt(v) equal but for codes one apart at a rounding boundary,
    under 1 in 1,000, the scales within 1e-4 relative (C11: the
    reference's jitted compressed step cannot run).
"""
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
from repro_torch.common import tree as TR
from repro_torch.common.types import OptimizerConfig, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.optim import adamw
from repro_torch.train import trainer

GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
MAX_CODE_FLIPS = 1e-3
BATCH, SEQ = 4, 32


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


def check_three_steps(cfg, jcfg, jparams) -> list:
    """Three steps (microbatches 2) against the reference's jitted step;
    the port's losses."""
    jt = JTrain(steps=3, seq_len=SEQ, global_batch=BATCH, microbatches=2,
                optimizer=JOpt(lr=1e-3, warmup_steps=1))
    tcfg = TrainConfig(steps=3, seq_len=SEQ, global_batch=BATCH,
                       microbatches=2,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1))
    jstep, _ = JTR.make_train_step(jcfg, jt)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jopt = JA.init(jp, jt.optimizer)
    step, _ = trainer.make_train_step(cfg, tcfg)
    p = params(cfg, jparams)
    opt = adamw.init(p, tcfg.optimizer)
    losses = []
    for i in range(3):
        jp, jopt, jm = jstep(jp, jopt, jbatch(jcfg, i))
        p, opt, m = step(p, opt, batch(cfg, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_TOL)
        losses.append(float(m["loss"]))
    want = dict(TR.leaves_with_paths(jax.tree_util.tree_map(np.asarray, jp)))
    for path, x in TR.leaves_with_paths(p):
        assert norm_err(x, want[path]) <= GRAD_TOL, path
    return losses


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
