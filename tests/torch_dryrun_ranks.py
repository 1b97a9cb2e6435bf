"""Rank entry points for tests/test_torch_dryrun.py (a spawned rank imports
its target by module name; this module imports neither JAX nor the JAX
package)."""
import torch.distributed as dist

from repro_torch.common.types import MeshConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw
from repro_torch.train import trainer


def collective_bytes(group, runs, shape) -> list:
    """For each (model config, TrainConfig) of ``runs``: one
    ``make_train_step(mesh=)`` step on a (data, model) mesh of ``shape``
    from the seeded params, with every ``all_reduce`` and ``broadcast``
    this rank makes in the step tallied by the bytes of the tensor it
    hands over."""
    tally = {"all_reduce": 0, "broadcast": 0}
    real = {k: getattr(dist, k) for k in tally}

    def counted(kind):
        def call(tensor, *a, **kw):
            tally[kind] += tensor.numel() * tensor.element_size()
            return real[kind](tensor, *a, **kw)
        return call

    mesh = make_mesh(MeshConfig(shape=tuple(shape), axes=("data", "model")),
                     group)
    out = []
    for cfg, tcfg in runs:
        step, sh = trainer.make_train_step(cfg, tcfg, mesh)
        p = sh["params"].shard(trainer.init_params(cfg, 0, "cpu"))
        opt = adamw.init(p, tcfg.optimizer, sharding=sh["params"])
        batch = sh["batch"].shard(make_batch(
            cfg, 0, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            device="cpu"))
        for k in tally:
            tally[k] = 0
            setattr(dist, k, counted(k))
        try:
            step(p, opt, batch)
        finally:
            for k, fn in real.items():
                setattr(dist, k, fn)
        out.append(dict(tally))
    return out
