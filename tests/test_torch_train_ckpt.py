"""The port's checkpoints, elastic planning and training launcher
(``train/checkpoint.py``, ``train/elastic.py``, ``launch/train.py``) on the
CPU, against the JAX package where both have the function: a checkpoint
of {params, opt} written by either package restores in the other byte for
byte (REDUCED llama3-8b in float32, raw and compressed AdamW state); the
reference's round-trip, GC, corruption, async, mesh-planning and straggler
cases; the launcher with and without ``--compress-state``, its resume and
its retry from the last checkpoint."""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import OptimizerConfig as JOpt
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import checkpoint as JC
from repro.train import elastic as JE
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common import tree as TR
from repro_torch.common.types import OptimizerConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import train as LT
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic


def _tree():
    return {"a": torch.arange(8, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)},
            "d": [torch.tensor([1, 2], dtype=torch.int32), 7]}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.list_steps(d) == [3, 4]
    assert ckpt.latest(d) == 4
    like = TR.map_tree(lambda x: torch.zeros_like(x)
                       if isinstance(x, torch.Tensor) else 0, tree)
    back, extra = ckpt.restore(d, 4, like)
    assert extra == {}
    for (_, a), (_, b) in zip(TR.leaves_with_paths(tree),
                              TR.leaves_with_paths(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b and isinstance(b, int)


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(1024, dtype=torch.float32)}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, tree)
    npz = glob.glob(os.path.join(d, "step_00000002", "arrays.npz"))[0]
    with open(npz, "r+b") as f:
        f.seek(120)
        f.write(b"\xde\xad\xbe\xef")
    assert ckpt.latest(d) == 1
    os.remove(os.path.join(d, "step_00000001", "manifest.json"))
    assert ckpt.latest(d) is None


def test_checkpoint_async_one_sync(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.ones((64,), dtype=torch.float32),
            "b": torch.zeros((4,), dtype=torch.bfloat16)}
    contracts.SYNCS.reset()
    t = ckpt.save_async(d, 5, tree)
    assert contracts.SYNCS.count == 1        # one host copy of every leaf
    ckpt.wait_pending()
    assert not t.is_alive()
    assert ckpt.latest(d) == 5


def test_restore_refuses_another_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, {"a": torch.zeros((5,))})


@pytest.fixture(scope="module")
def states():
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    jcfg = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    rng = np.random.default_rng(0)
    out = {}
    for comp in (False, True):
        jst = JA.init(jparams, JOpt(compress_state=comp))
        g = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2,
                                  jnp.float32), jparams)
        jp, jst, _ = JA.update(g, jst, jparams, JOpt(compress_state=comp,
                                                     warmup_steps=1))
        out[comp] = (jp, jst)
    return cfg, out


def _host(x) -> np.ndarray:
    """numpy bytes of a leaf (bf16 tensors as their int16 bits)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _equal_trees(a, b):
    da, db = dict(TR.leaves_with_paths(a)), dict(TR.leaves_with_paths(b))
    assert set(da) == set(db)
    for k, x in da.items():
        y = db[k]
        if isinstance(x, int) or isinstance(y, int):
            assert int(np.asarray(x)) == int(np.asarray(y)), k
            continue
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("comp", [False, True])
def test_jax_checkpoint_restores_in_port(tmp_path, states, comp):
    cfg, out = states
    jp, jst = out[comp]
    d = str(tmp_path / "ck")
    JC.save(d, 3, {"params": jp, "opt": jst})
    assert ckpt.latest(d) == 3
    like_p = interop.stacked_params_from_numpy(
        jax.tree_util.tree_map(np.zeros_like, jp), cfg, device="cpu")
    like = {"params": like_p,
            "opt": adamw.init(like_p, OptimizerConfig(compress_state=comp))}
    tree, _ = ckpt.restore(d, 3, like)
    _equal_trees({"params": interop.stacked_params_to_numpy(tree["params"]),
                  "opt": interop.opt_state_to_numpy(tree["opt"])},
                 {"params": jp, "opt": jst})
    assert int(tree["opt"].step) == 1


@pytest.mark.parametrize("comp", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, states, comp):
    cfg, out = states
    jp, jst = out[comp]
    params = interop.stacked_params_from_numpy(jp, cfg, device="cpu")
    opt = interop.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, {"params": params, "opt": opt}, extra={"arch": "x"})
    assert JC.latest(d) == 3
    like = jax.tree_util.tree_map(jnp.zeros_like, {"params": jp, "opt": jst})
    tree, extra = JC.restore(d, 3, like)
    assert extra == {"arch": "x"}
    _equal_trees(tree, {"params": jp, "opt": jst})


def test_plan_mesh_factors():
    for kw in (dict(n_devices=512, prefer_model=16, pods=2),
               dict(n_devices=256, prefer_model=16),
               dict(n_devices=6, prefer_model=16), dict(n_devices=1)):
        assert dataclasses.asdict(elastic.plan_mesh(**kw)) == \
            dataclasses.asdict(JE.plan_mesh(**kw))
    m = elastic.plan_mesh(512, prefer_model=16, pods=2)
    assert m.shape == (2, 16, 16) and m.axes == ("pod", "data", "model")
    assert elastic.plan_mesh(256, prefer_model=16).shape == (16, 16)
    assert elastic.plan_mesh(6, prefer_model=16).num_devices == 6


@pytest.mark.parametrize("lost", [1, 16, 100])
def test_degraded_plan(lost):
    old = elastic.plan_mesh(512, prefer_model=16, pods=2)
    new = elastic.degraded_plan(old, lost_devices=lost)
    assert new.num_devices <= 512 - lost
    assert new.num_devices % new.shape[-1] == 0
    assert dataclasses.asdict(new) == dataclasses.asdict(
        JE.degraded_plan(JE.plan_mesh(512, prefer_model=16, pods=2), lost))


def test_straggler_monitor():
    mon, jmon = elastic.StragglerMonitor(4), JE.StragglerMonitor(4)
    for _ in range(5):
        for r in range(4):
            t = 1.0 if r != 2 else 3.5
            mon.record(r, t)
            jmon.record(r, t)
    assert mon.stragglers() == jmon.stragglers() == [2]
    assert mon.ewma == jmon.ewma


def _argv(steps: int, *extra: str):
    return ["--arch", "llama3_8b", "--reduced", "--steps", str(steps),
            "--seq-len", "32", "--global-batch", "4", "--device", "cpu",
            *extra]


@pytest.mark.parametrize("comp", [False, True])
def test_launcher_trains_on_cpu(tmp_path, capsys, comp):
    argv = _argv(3, "--ckpt-dir", str(tmp_path / "ck"),
                 *(["--compress-state"] if comp else []))
    contracts.SYNCS.reset()
    out = LT.main(argv)
    text = capsys.readouterr().out
    assert "training complete" in text
    assert "step    0  loss=" in text and "step    2  loss=" in text
    assert contracts.SYNCS.count == 2        # one a printed step
    assert sorted(out["metrics"]) == [0, 1, 2] and out["start"] == 0
    assert all(np.isfinite(float(m["loss"])) for m in out["metrics"].values())
    leaf = out["opt"].m["layers"]["mlp"]["wi"]
    assert isinstance(leaf, dict) == comp
    assert ckpt.list_steps(str(tmp_path / "ck")) == []   # every 50 steps


def test_launcher_resumes_where_it_stopped(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = _argv(4, "--ckpt-dir", d, "--ckpt-every", "2", "--compress-state")
    whole = LT.main(argv)
    assert ckpt.list_steps(d) == [2, 4]
    like = {"params": whole["params"], "opt": whole["opt"]}
    back, _ = ckpt.restore(d, 4, like)
    _equal_trees(back, like)
    # a run that stopped after step 2 resumes there: same loss at step 2
    os.rename(os.path.join(d, "step_00000004"), os.path.join(d, "gone_4"))
    again = LT.main(argv)
    assert again["start"] == 2 and sorted(again["metrics"]) == [2, 3]
    assert "resumed from step 2" in capsys.readouterr().out
    for s in (2, 3):
        assert float(again["metrics"][s]["loss"]) == \
            float(whole["metrics"][s]["loss"])
    _equal_trees({"params": again["params"], "opt": again["opt"]}, like)


def test_launcher_retries_a_failed_step_from_the_checkpoint(
        tmp_path, capsys, monkeypatch):
    d = str(tmp_path / "ck")
    real = LT.make_batch
    failed = []

    def flaky(cfg, step, **kw):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected")
        return real(cfg, step, **kw)
    monkeypatch.setattr(LT, "make_batch", flaky)
    out = LT.main(_argv(4, "--ckpt-dir", d, "--ckpt-every", "2"))
    text = capsys.readouterr().out
    assert "step 3 failed (injected); retrying from last checkpoint" in text
    assert out["retries"] == 1 and sorted(out["metrics"]) == [0, 1, 2, 3]
