"""Rank entry points for tests/test_torch_train_mesh.py (a spawned rank
imports its target by module name; this module imports neither JAX nor
the JAX package, so a rank starts quickly)."""
import torch

from repro_torch.common import sharding as SH


def collectives_in_pieces(group, piece_bytes: int) -> dict:
    """On a (2, 2) mesh with collectives cut into ``piece_bytes`` pieces:
    ``shard`` then ``gather`` of an 8 x 6 leaf under every spec gives the
    leaf back bit for bit; ``psum`` over each set of axes and ``scatter``
    give the sums of the ranks' multiples of it."""
    SH.COLLECTIVE_BYTES = piece_bytes
    mesh = SH.Mesh((2, 2), ("data", "model"), group.rank, group.device)
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6) - 7.5
    full[0, 0] = -0.0
    mine = full * (group.rank + 1)
    out = {}
    for spec in [("data",), (None, "model"), ("data", "model"),
                 (("data", "model"),), ("model", "data")]:
        back = mesh.gather(mesh.shard(full, spec), spec)
        out[f"gather {spec}"] = torch.equal(back.view(torch.int32),
                                            full.view(torch.int32))
    for axes, ranks in ((None, (0, 1, 2, 3)),
                        ("data", (mesh.coord["model"],
                                  2 + mesh.coord["model"])),
                        ("model", (2 * mesh.coord["data"],
                                   2 * mesh.coord["data"] + 1))):
        want = full * sum(r + 1 for r in ranks)
        out[f"psum {axes}"] = torch.equal(mesh.psum(mine, axes), want)
        if axes is not None:
            spec = (axes,)
            out[f"scatter {axes}"] = torch.equal(mesh.scatter(mine, spec),
                                                 mesh.shard(want, spec))
    return out


def mesh_steps(group, shape, runs) -> list:
    """``trainer.run_mesh_steps`` on a mesh of ``shape`` for each (model
    config, TrainConfig, the reference's params as numpy, global batches,
    ``enter_input``) of ``runs`` in turn; with ``enter_input`` MLA's
    normed input is entered as well as its latents (each gradient that
    reaches it then counted once a rank of the model axis). Rank 0's
    records (losses, grad norms, the end params and state gathered);
    None on the others."""
    from repro_torch.models import layers as L
    from repro_torch.train import trainer
    out = []
    mla = L.mla_apply_train
    for cfg, tcfg, params, batches, enter_input in runs:
        if enter_input:
            L.mla_apply_train = lambda p, x, c, impl="auto", mesh=None: mla(
                p, mesh.enter(x), c, impl, mesh)
        try:
            out.append(trainer.run_mesh_steps(group, cfg, tcfg, shape,
                                              params, batches))
        finally:
            L.mla_apply_train = mla
    return out if group.rank == 0 else None
