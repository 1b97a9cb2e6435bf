"""The port's data-parallel step with int8 error-feedback gradient
collectives (``train/trainer.py::make_dp_compressed_step``) on gloo ranks on
the CPU, against the JAX package's ``make_dp_compressed_step``.

REDUCED llama3-8b (2 layers, d 256) in float32, ``TrainConfig()``'s
defaults (``compress_state=False``: the reference's compressed state cannot
run under ``jit``, C11), params from the reference's
``init_params(PRNGKey(0))``, 3 steps over global batches of 4 x 32 tokens
(``data.pipeline.make_batch``), each rank taking its rows. The port's ranks
are spawned (``sharding.spawn_ranks``, one thread each); the JAX step runs
on a one-device ``("data",)`` mesh in this process at D = 1, and at D = 2
in a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
(the reference's own mechanism), both started while the ranks run.

Tolerances, those of tests/test_torch_train.py, each measured here and
stated with its margin:
  * losses at rtol 1e-5 (measured 1e-7), params normwise 1e-4 (measured
    3.5e-7 to 7.1e-7): float32 sums in another order (the port's
    all_reduce against XLA's psum_scatter);
  * the gradient's 8-bit codes sit one apart where a value lies at a
    rounding boundary, so the moments and the residuals differ in isolated
    values: under 1 in 1,000 of them (MAX_CODE_FLIPS) off by more than 1e-5
    of their leaf's largest moment (measured 4.4e-4 and 1.1e-4 of the
    values) or 1e-3 of its largest residual (measured 4.9e-4 and 6.9e-5).
A leaf under the 4 D rule takes the plain mean; the others equal the
reference's codec (``optim/gradcomp.py``) composed by hand, code for code.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import gradcomp as JG  # noqa: E402
from repro_torch.common import sharding as SH  # noqa: E402
from repro_torch.common import tree as TR  # noqa: E402
from repro_torch.common.types import TrainConfig  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
MAX_CODE_FLIPS = 1e-3
MOMENT_OFF = 1e-5
RESIDUAL_OFF = 1e-3
STEPS = 3
RANK_TIMEOUT = 300.0
SRC = Path(__file__).resolve().parents[1] / "src"


def _jax_cfg():
    return dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def jax_dp_run(n_dev: int) -> dict:
    """The reference's DP step over STEPS batches on ``n_dev`` devices:
    losses and every leaf of params ("p:"), moments ("m:", "v:") and
    residuals ("r:", [D, size])."""
    from jax.sharding import Mesh
    from repro.common.types import TrainConfig as JTrain
    from repro.optim import adamw as JA
    from repro.train import trainer as JTR
    jcfg, tcfg = _jax_cfg(), JTrain()
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    step = JTR.make_dp_compressed_step(jcfg, tcfg, mesh)
    opt = JA.init(params, tcfg.optimizer)
    res = JTR.init_residual_flat(params, n_dev)
    losses = []
    for i in range(STEPS):
        params, opt, res, m = step(params, opt, res, _jbatch(jcfg, i))
        losses.append(float(m["loss"]))
    out = {"losses": np.asarray(losses)}
    for pre, tree in (("p:", params), ("m:", opt.m), ("v:", opt.v),
                      ("r:", res)):
        for path, x in jax.tree_util.tree_leaves_with_path(tree):
            out[pre + _key(path)] = np.asarray(x)
    return out


def _jbatch(jcfg, i):
    return {k: np.asarray(v) for k, v in
            jmake_batch(jcfg, i, global_batch=4, seq_len=32).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (the port's rank-0 result, the reference's)} for D = 1, 2."""
    import concurrent.futures as cf
    jcfg = _jax_cfg()
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
    batches = [_jbatch(jcfg, i) for i in range(STEPS)]
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    sub = subprocess.Popen([sys.executable, __file__, str(tmp / "j2.npz")],
                           env=env)

    def ranks():
        return {d: SH.spawn_ranks(
            trainer.run_dp_steps, d, backend="gloo",
            args=(cfg, TrainConfig(), jparams, batches), device="cpu",
            workdir=str(tmp / f"d{d}"), timeout=RANK_TIMEOUT)[0]
            for d in (1, 2)}

    try:
        with cf.ThreadPoolExecutor(1) as pool:
            port = pool.submit(ranks)
            j1 = jax_dp_run(1)
            port = port.result()
        assert sub.wait(timeout=RANK_TIMEOUT) == 0
    finally:
        if sub.poll() is None:
            sub.kill()
    return {1: (port[1], j1), 2: (port[2], dict(np.load(tmp / "j2.npz")))}


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _off_share(pairs, rel) -> float:
    """Share of values farther apart than ``rel`` of their leaf's largest."""
    off = total = 0
    for got, want in pairs:
        d = np.abs(np.asarray(got, np.float64) - want)
        off += int((d > rel * np.abs(want).max()).sum())
        total += d.size
    return off / total


@pytest.mark.parametrize("n_devices", [1, 2])
def test_dp_step_matches_reference(runs, n_devices):
    """Losses, params, moments and every rank's residual after 3 steps
    against the reference's (module docstring's tolerances)."""
    got, want = runs[n_devices]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    params = list(TR.leaves_with_paths(got["params"]))
    assert len(params) == sum(k.startswith("p:") for k in want)
    for path, x in params:
        assert _norm_err(x, want["p:" + "/".join(path)]) <= PARAM_TOL, path
    for pre, tree in (("m:", got["opt"].m), ("v:", got["opt"].v)):
        pairs = [(x, want[pre + "/".join(path)])
                 for path, x in TR.leaves_with_paths(tree)]
        assert _off_share(pairs, MOMENT_OFF) < MAX_CODE_FLIPS, pre
    assert sorted(got["residual"]) == sorted(
        k[2:] for k in want if k.startswith("r:"))
    pairs = [(x, want["r:" + k]) for k, x in got["residual"].items()]
    assert all(x.shape == (n_devices,) + w.shape[1:] for x, w in pairs)
    assert _off_share(pairs, RESIDUAL_OFF) < MAX_CODE_FLIPS
    assert any(np.abs(x).max() > 0 for x, _ in pairs)     # feedback live


def test_tiny_leaves_take_the_plain_mean(tmp_path):
    """D = 2: leaves of 6 values (< 4 D) and 9 (odd) are the plain mean
    of the ranks' gradients, their residuals untouched; leaves of 1,024
    and 3 x 512 values go through the codec: each rank's slice of the
    mean plus its residual coded to 8 bits (blocks of 512 / 768), every
    rank's codes gathered and decoded, equal to the reference's
    ``gradcomp`` composed by hand (residuals within 1e-7, as
    tests/test_torch_train.py holds the codec)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (6,), "b": (9,), "c": (1024,), "d": (3, 512)}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    res = [{k: (rng.standard_normal((1, int(np.prod(s)))) * 1e-3)
            .astype(np.float32) for k, s in shapes.items()}
           for _ in range(2)]
    out = SH.spawn_ranks(trainer.mean_grads_on_ranks, 2, backend="gloo",
                         args=(grads, res), device="cpu",
                         workdir=str(tmp_path), timeout=RANK_TIMEOUT)
    mean0, mean1 = out[0][0], out[1][0]
    for k in shapes:
        np.testing.assert_array_equal(mean0[k], mean1[k])
    for k in ("a", "b"):
        np.testing.assert_array_equal(mean0[k],
                                      (grads[0][k] + grads[1][k]) / 2)
        for r in range(2):
            np.testing.assert_array_equal(out[r][1][k], res[r][k])
    for k in ("c", "d"):
        flat = ((grads[0][k] + grads[1][k]) / 2).reshape(-1)
        n = flat.size
        ns = n // 2
        blk = JG._block_for(ns, 512)
        codes, scales = [], []
        for r in range(2):
            corr = flat[r * ns:(r + 1) * ns] + res[r][k][0, :ns]
            c = JG.compress_leaf(corr, blk)
            back = np.asarray(JG.decompress_leaf(c, (ns,), blk))
            np.testing.assert_allclose(out[r][1][k][0, :ns], corr - back,
                                       atol=1e-7)
            np.testing.assert_array_equal(out[r][1][k][0, ns:],
                                          res[r][k][0, ns:])
            codes.append(np.asarray(c["codes"]))
            scales.append(np.asarray(c["scales"]))
        want = JG.decompress_leaf({"codes": np.concatenate(codes),
                                   "scales": np.concatenate(scales)},
                                  (n,), blk)
        np.testing.assert_array_equal(mean0[k].reshape(-1),
                                      np.asarray(want))


if __name__ == "__main__":
    np.savez(sys.argv[1], **jax_dp_run(2))
