"""The port's mesh train step (``trainer.make_train_step(mesh=)``: FSDP
over ``data``, tensor parallel over ``model``) on gloo ranks on the CPU,
against the JAX package's GSPMD step ``make_train_step(mesh=Mesh(...))``.

REDUCED llama3-8b (2 layers, d 256, 4/2 heads of 64, d_ff 512, vocab 512)
in float32, params from the reference's ``init_params(PRNGKey(0))``, 3
steps over global batches of 4 x 32 tokens (``data.pipeline.make_batch``).
The raw state (``compress_state=False``): the reference's compressed state
cannot run under ``jit`` (C11). The port's ranks are spawned
(``sharding.spawn_ranks``, one thread each) at the meshes (data, model) =
(1, 1), (2, 1), (1, 2) and (2, 2); the reference runs all four in one
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the reference's own mechanism; about 25 s, beside the ranks).

Tolerances, those of tests/test_torch_train_dp.py, each measured here and
stated with its margin:
  * losses and grad norms at rtol 1e-5 (measured at most 1.5e-7 and
    2.1e-7), params and moments normwise 1e-4 (measured at most 3.2e-8
    and 1.9e-6): float32 sums in another order (the tensor-parallel
    partial sums, the data ranks' gradient sums);
  * the compressed state (B3 codes and scales) against the port's own
    single-device step: byte for byte at (1, 1); at (2, 2) codes one apart
    at a rounding boundary, under 1 in 1,000 (MAX_CODE_FLIPS; measured 90
    of 2,886,144, 3.1e-5), the scales within 1e-5 relative (measured
    2.5e-6);
  * checkpoints: the (2, 2) ranks' save of the starting state is byte for
    byte the single-device save of the same params (the manifests' hashes
    equal); restored from (2, 2)'s step 3 onto (1, 2) and onto one device,
    the next step's loss equals the reference's fourth within 1e-5
    (measured 0 on (1, 2)).
The file takes about 50 s on this CPU (the ranks and the reference's
subprocess side by side).
"""
import concurrent.futures as cf
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common import sharding as SH  # noqa: E402
from repro_torch.common import tree as TR  # noqa: E402
from repro_torch.common.types import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
MAX_CODE_FLIPS = 1e-3
SCALE_RTOL = 1e-5
STEPS = 3
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
RANK_TIMEOUT = 300.0
SRC = Path(__file__).resolve().parents[1] / "src"
RAW = TrainConfig()
COMPRESSED = TrainConfig(optimizer=OptimizerConfig(compress_state=True))


def _jax_cfg():
    return dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _jbatch(jcfg, i):
    return {k: np.asarray(v) for k, v in
            jmake_batch(jcfg, i, global_batch=4, seq_len=32).items()}


def jax_mesh_runs() -> dict:
    """The reference's GSPMD step on each mesh of MESHES over 4 forced
    host devices: STEPS steps, then one more (its loss only); losses, grad
    norms and every leaf of params ("p:"), moments ("m:", "v:") after
    STEPS, keyed "<data>x<model>|..."."""
    from jax.sharding import Mesh
    from repro.common.types import TrainConfig as JTrain
    from repro.optim import adamw as JA
    from repro.train import trainer as JTR
    jcfg, tcfg = _jax_cfg(), JTrain()
    out = {}
    for shape in MESHES:
        tag = "%dx%d|" % shape
        params, axes = JT.init_params(jax.random.PRNGKey(0), jcfg)
        mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]])
                    .reshape(shape), ("data", "model"))
        step, sh = JTR.make_train_step(jcfg, tcfg, mesh=mesh,
                                       param_axes=axes)
        params = jax.device_put(params, sh["params"])
        opt = jax.device_put(JA.init(params, tcfg.optimizer), sh["opt"])
        losses, norms = [], []
        for i in range(STEPS + 1):
            if i == STEPS:
                for pre, tree in (("p:", params), ("m:", opt.m),
                                  ("v:", opt.v)):
                    for path, x in jax.tree_util.tree_leaves_with_path(tree):
                        out[tag + pre + _key(path)] = np.asarray(x)
            b = jax.device_put(_jbatch(jcfg, i), sh["batch"])
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[tag + "losses"] = np.asarray(losses)
        out[tag + "grad_norms"] = np.asarray(norms)
    return out


def _single_run(cfg, tcfg, jparams, batches):
    """The port's one-device step over ``batches`` in this process at one
    thread (as a spawned rank runs): (losses, params, state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p = interop.stacked_params_from_numpy(jparams, cfg, "cpu")
        opt = adamw.init(p, tcfg.optimizer)
        step = trainer.make_train_step(cfg, tcfg)[0]
        losses = []
        for b in batches:
            p, opt, m = step(p, opt, {k: torch.from_numpy(np.array(v))
                                      for k, v in b.items()})
            losses.append(float(m["loss"]))
        return losses, p, opt
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (``jax_mesh_runs``) and the port's: the raw
    state on every mesh, (2, 2) saving steps 0 and 3; the compressed state
    at (1, 1) and (2, 2) and on one device; (1, 2) and one device restored
    from (2, 2)'s step 3 for the next step."""
    jcfg = _jax_cfg()
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
    batches = [_jbatch(jcfg, i) for i in range(STEPS + 1)]
    tmp = tmp_path_factory.mktemp("mesh")
    ck = str(tmp / "ck")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    sub = subprocess.Popen([sys.executable, __file__, str(tmp / "j.npz")],
                           env=env)

    def spawn(shape, tcfg, name, **kw):
        return SH.spawn_ranks(
            trainer.run_mesh_steps, shape[0] * shape[1], backend="gloo",
            args=(cfg, tcfg, shape, jparams, kw.pop("batches",
                                                    batches[:STEPS])),
            kwargs=kw, device="cpu", workdir=str(tmp / name),
            timeout=RANK_TIMEOUT)[0]

    port = {}
    try:
        with cf.ThreadPoolExecutor(3) as pool:
            first = pool.submit(spawn, (2, 2), RAW, "raw22", ckpt_dir=ck,
                                save_at=(0, STEPS))
            rest = {s: pool.submit(spawn, s, RAW, "raw%dx%d" % s)
                    for s in MESHES[:3]}
            comp = {s: pool.submit(spawn, s, COMPRESSED, "c%dx%d" % s)
                    for s in ((1, 1), (2, 2))}
            single = _single_run(cfg, COMPRESSED, jparams, batches[:STEPS])
            port[(2, 2)] = first.result()
            restored = pool.submit(spawn, (1, 2), RAW, "r12", ckpt_dir=ck,
                                   restore_step=STEPS,
                                   batches=batches[STEPS:])
            port.update({s: f.result() for s, f in rest.items()})
            port["comp"] = {s: f.result() for s, f in comp.items()}
            port["restored"] = restored.result()
        assert sub.wait(timeout=RANK_TIMEOUT) == 0
    finally:
        if sub.poll() is None:
            sub.kill()
    return types.SimpleNamespace(
        cfg=cfg, jparams=jparams, batches=batches, ck=ck, tmp=tmp,
        port=port, single=single, ref=dict(np.load(tmp / "j.npz")))


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_mesh_step_matches_reference(runs, shape):
    """Losses, grad norms, params and raw moments after 3 steps against
    the reference's GSPMD step on the same mesh."""
    got, tag = runs.port[shape], "%dx%d|" % shape
    np.testing.assert_allclose(got["losses"], runs.ref[tag + "losses"][:STEPS],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"],
                               runs.ref[tag + "grad_norms"][:STEPS],
                               rtol=LOSS_RTOL)
    n = 0
    for pre, tree in (("p:", got["params"]), ("m:", got["opt"].m),
                      ("v:", got["opt"].v)):
        for path, x in TR.leaves_with_paths(tree):
            want = runs.ref[tag + pre + "/".join(path)]
            assert x.shape == want.shape, path
            assert _norm_err(x, want) <= PARAM_TOL, (pre, path)
            n += 1
    assert n == sum(k.startswith(tag + p) for k in runs.ref
                    for p in ("p:", "m:", "v:"))


def test_grad_norm_counts_replicated_leaves_once(runs):
    """At (2, 2) the norms and the vocab leaves are held twice over
    ``data``: counted per copy, the grad norm would exceed the one-device
    norm by their share. It equals the reference's one-mesh and one-device
    norm (the (1, 1) run) within 1e-5."""
    one = runs.port[(1, 1)]["grad_norms"]
    for shape in MESHES[1:]:
        np.testing.assert_allclose(runs.port[shape]["grad_norms"], one,
                                   rtol=LOSS_RTOL)


def _codes(opt):
    return [(path, x) for path, x in TR.leaves_with_paths((opt.m, opt.v))
            if path[-1] in ("codes", "scales")]


def test_compressed_state_on_mesh(runs):
    """B3's codes and scales of m and sqrt(v): at (1, 1) byte for byte the
    one-device step's; at (2, 2) codes one apart at rounding boundaries,
    under MAX_CODE_FLIPS, scales within SCALE_RTOL."""
    losses, _, opt = runs.single
    want = interop.opt_state_to_numpy(opt)
    one = runs.port["comp"][(1, 1)]
    assert one["losses"] == losses
    for (path, x), (_, w) in zip(_codes(one["opt"]), _codes(want)):
        assert x.dtype == w.dtype and np.array_equal(x, w), path
    four = runs.port["comp"][(2, 2)]
    np.testing.assert_allclose(four["losses"], losses, rtol=LOSS_RTOL)
    flips = total = 0
    for (path, x), (_, w) in zip(_codes(four["opt"]), _codes(want)):
        if path[-1] == "codes":
            flips += int((x != w).sum())
            total += x.size
        else:
            np.testing.assert_allclose(x, w, rtol=SCALE_RTOL)
    assert flips <= MAX_CODE_FLIPS * total, (flips, total)
    assert four["opt"].m["layers"]["attn"]["wq"]["codes"].shape == \
        (runs.cfg.num_layers * 256 * 256,)         # the whole leaf


def test_checkpoint_from_mesh_equals_single_device_save(runs, tmp_path):
    """The (2, 2) ranks' save of the starting state (every leaf gathered
    whole, written by rank 0) against the one-device save of the same
    params and zero state: the same keys and bytes."""
    p = interop.stacked_params_from_numpy(runs.jparams, runs.cfg, "cpu")
    tree = {"params": p, "opt": adamw.init(p, RAW.optimizer)}
    ckpt.save(str(tmp_path), 0, tree)
    manifests = [json.loads((Path(d) / "step_00000000" / "manifest.json")
                            .read_text()) for d in (runs.ck, tmp_path)]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["sha256"] == manifests[1]["sha256"]
    assert ckpt.list_steps(runs.ck) == [0, STEPS]


def test_checkpoint_restores_onto_another_mesh_and_one_device(runs):
    """(2, 2)'s step-3 checkpoint onto (1, 2) (spawned) and onto one
    device (here): the next step's loss equals the reference's fourth."""
    want = runs.ref["2x2|losses"][STEPS]
    np.testing.assert_allclose(runs.port["restored"]["losses"], [want],
                               rtol=LOSS_RTOL)
    p = interop.stacked_params_from_numpy(runs.jparams, runs.cfg, "cpu")
    tree, _ = ckpt.restore(runs.ck, STEPS,
                           {"params": p, "opt": adamw.init(p, RAW.optimizer)})
    step = trainer.make_train_step(runs.cfg, RAW)[0]
    _, _, m = step(tree["params"], tree["opt"],
                   {k: torch.from_numpy(np.array(v))
                    for k, v in runs.batches[STEPS].items()})
    np.testing.assert_allclose(float(m["loss"]), want, rtol=LOSS_RTOL)


def test_mesh_collectives_in_pieces(tmp_path):
    """``Mesh.gather``/``psum``/``scatter`` on four gloo ranks at (2, 2)
    with every collective cut into 20-byte pieces: each leaf back bit for
    bit (a -0.0 included) under five specs, the sums over each set of
    axes exact (``tests/torch_mesh_ranks.py``)."""
    import torch_mesh_ranks
    outs = SH.spawn_ranks(torch_mesh_ranks.collectives_in_pieces, 4,
                          backend="gloo", args=(20,), device="cpu",
                          workdir=str(tmp_path), timeout=RANK_TIMEOUT)
    for r, out in enumerate(outs):
        assert len(out) == 10 and all(out.values()), (r, out)


@pytest.mark.parametrize("arch", ["llama3_8b", "zamba2_2p7b"])
def test_launcher_devices_2_trains_on_the_planned_mesh(tmp_path, capfd,
                                                       arch):
    """``launch/train.py --devices 2 --device cpu`` spawns two gloo ranks
    and trains on ``plan_mesh(2, prefer_model=2)``: rank 0 prints the mesh
    as the reference's launcher does and returns three finite losses (the
    hybrid too: its mixers' heads over model)."""
    from repro_torch.launch import train as LT
    out = LT.main(["--arch", arch, "--reduced", "--devices", "2",
                   "--device", "cpu", "--steps", "3", "--seq-len", "32",
                   "--global-batch", "4", "--ckpt-dir", str(tmp_path)])
    text = capfd.readouterr().out
    assert "mesh: {'data': 1, 'model': 2}" in text
    assert text.count("mesh: ") == 1 and "training complete" in text
    assert out["mesh"] == {"data": 1, "model": 2}
    assert sorted(out["losses"]) == [0, 1, 2]
    assert all(np.isfinite(v) for v in out["losses"].values())


if __name__ == "__main__":
    np.savez(sys.argv[1], **jax_mesh_runs())
