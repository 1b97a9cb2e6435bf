"""Ranks of the expander axis (the expander half of the reference's
``repro.common.sharding``; DESIGN.md §17).

The reference runs the sharded fabric as one program over a device mesh
(``shard_map`` over the ``expander`` axis). PyTorch's idiom for several
devices is one process per device, so the port runs SPMD ranks over
``torch.distributed``: each rank holds the replicated host state and its
own block of ``N / D`` expanders, and every host decision is made from
values gathered collectively, never from rank-local ones.

Every collective here is one of the two that both backends take on CUDA
tensors: an ``all_reduce(SUM)`` of masked contributions (``psum``), or a
``broadcast`` from a rank every rank can name (``bcast``). An all-gather
(``gather_tree``) is an all_reduce of a zero-filled ``[D, bytes]`` buffer in
which each rank fills its own row with its tensors' bytes, so adding zeros
is exact whatever the dtype (the reference's psum trick, fabric/shard.py).

Backends: NCCL on cards ``cuda:0..D-1`` (rank r's default device is
``cuda:r``; fewer visible cards than ranks raises, as the reference's
``expander_mesh`` raises); gloo on the CPU (the tests) or on one card that
several ranks share (NCCL refuses two ranks on one card). Nothing here falls
back to another backend or device: the caller names both.

``spawn_ranks`` starts D ranks as processes (``torch.multiprocessing``'s
spawn) with a ``file://`` rendezvous, runs ``fn(group, *args, **kwargs)``
on each and returns what each returned; a rank that fails or a run past
its time limit stops every rank and raises. With a ``gate`` path the ranks start up (the
interpreter, the group, the device's context) and then wait for that file
to exist, so a caller can pay their start-up while it does other work.

The GSPMD half (the reference's ``DEFAULT_RULES``, ``logical_to_spec``,
``tree_shardings``, ``batch_spec``): every param and activation names its
dims with logical axes, and a rule table maps them to mesh axes. A spec
here is a plain tuple (an entry a dim: None, a mesh axis, or a tuple of
them; trailing Nones trimmed), the entries of the reference's
``PartitionSpec``. ``Mesh`` lays the world's ranks out row-major over its
axes, ``(data, model)`` or ``(pod, data, model)``, with one process group
for each row of each set of axes; its ``gather`` (an all-gather: each rank
of the group broadcasts its block in turn, exact for every dtype and half
the bytes of an all_reduce of the zero-filled leaf, which is what gloo's
1 GB/s all_reduce makes count), ``scatter`` (a reduce-scatter: a ``psum``
and the rank's block) and ``psum`` are the same two collectives.
``TreeSharding`` applies a tree of specs to whole trees. NCCL's
reduce-scatter and all-gather are not used (ROADMAP, held for after the
port).
"""
from __future__ import annotations

import itertools
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the fabric's device axis: one block of the stacked pool per rank
EXPANDER_AXIS = "expander"

_CURRENT: Optional["ExpanderGroup"] = None


def device_of_expander(n_expanders: int, n_devices: int) -> np.ndarray:
    """int [N]: which rank owns each expander (block layout)."""
    return np.arange(n_expanders) // (n_expanders // n_devices)


class ExpanderGroup:
    """One rank's view of the expander axis: its rank, the world size, its
    device, and the collectives (every rank must call each in the same
    order)."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, torch.device(device)

    def owned(self, n_expanders: int) -> range:
        """The global ids of this rank's expanders."""
        if n_expanders % self.world:
            raise ValueError(f"{n_expanders} expanders not divisible by "
                             f"{self.world} ranks")
        n_local = n_expanders // self.world
        return range(self.rank * n_local, (self.rank + 1) * n_local)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x`` (a new tensor)."""
        y = x.clone()
        dist.all_reduce(y)
        return y

    def bcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` as rank ``src`` holds it, on every rank (in place)."""
        dist.broadcast(x, src=src)
        return x

    def gather_tree(self, tree: Dict[str, torch.Tensor],
                    cat: bool = True) -> Dict[str, torch.Tensor]:
        """Every rank's tensors of ``tree``, in ONE collective: ``[D, ...]``
        a key, or with ``cat`` the ranks' leading axes concatenated (a
        rank's block of expanders -> all N)."""
        items = sorted(((k, v.detach().contiguous()) for k, v in tree.items()),
                       key=lambda kv: -kv[1].element_size())
        row = torch.cat([v.reshape(-1).view(torch.uint8) for _, v in items])
        buf = torch.zeros((self.world, row.numel()), dtype=torch.uint8,
                          device=row.device)
        buf[self.rank] = row
        dist.all_reduce(buf)
        out, o = {}, 0
        for k, v in items:
            n = v.numel() * v.element_size()
            a = buf[:, o:o + n].contiguous().view(v.dtype) \
                .reshape((self.world,) + tuple(v.shape))
            out[k] = a.reshape((self.world * v.shape[0],) +
                               tuple(v.shape[1:])) if cat and v.dim() else a
            o += n
        return out


def init_expander_ranks(world_size: int, rank: int, backend: str = "nccl",
                        init_method: str = "env://",
                        device=None) -> ExpanderGroup:
    """Join the rank group as ``rank`` of ``world_size`` and return its
    ``ExpanderGroup``. ``device`` defaults to ``cuda:<rank>``; under NCCL
    fewer visible cards than ranks raises, naming both counts."""
    global _CURRENT
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and n_cards < world_size:
        raise RuntimeError(f"{world_size} NCCL ranks need {world_size} "
                           f"visible CUDA devices; {n_cards} visible")
    if device is None:
        if n_cards <= rank:
            raise RuntimeError(f"rank {rank} has no CUDA device of its own "
                               f"({n_cards} visible): name its device")
        device = torch.device("cuda", rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _CURRENT = ExpanderGroup(rank, world_size, device)
    return _CURRENT


def current_group() -> ExpanderGroup:
    """The group ``init_expander_ranks`` joined; raises without one."""
    if _CURRENT is None or not dist.is_initialized():
        raise RuntimeError("no initialized rank group: call "
                           "common.sharding.init_expander_ranks on every rank "
                           "first (or spawn_ranks)")
    return _CURRENT


def leave_expander_ranks() -> None:
    """Leave the rank group (every rank calls it)."""
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank: int, world: int, backend: str, init_method: str,
                device, fn: Callable, args: Sequence, kwargs: dict,
                ret_path: str, gate: Optional[str]) -> None:
    torch.set_num_threads(1)
    group = init_expander_ranks(world, rank, backend, init_method, device)
    try:
        if gate is not None:
            torch.zeros((1,), device=group.device)    # the context, now
            while not os.path.exists(gate):
                time.sleep(0.01)
        out = fn(group, *args, **kwargs)
        with open(ret_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        leave_expander_ranks()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str,
                args: Sequence = (), kwargs: Optional[dict] = None,
                device=None, workdir: Optional[str] = None,
                timeout: float = 600.0,
                gate: Optional[str] = None) -> List[Any]:
    """Run ``fn(group, *args, **kwargs)`` on ``world_size`` spawned ranks
    (``fn`` a module-level function, so each process can import it) and
    return the ranks' return values in rank order. ``device`` names every rank's
    device (None: ``cuda:<rank>``). The rendezvous file lives in
    ``workdir`` (a temporary directory when None). A rank that exits with
    an error, or a run past ``timeout`` seconds (a rank stuck in a
    collective), stops every rank and raises. ``gate``: a path the ranks
    wait for after starting up (module docstring)."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "pg")
    if os.path.exists(init):
        os.remove(init)
    rets = [os.path.join(workdir, f"ret{r}.pkl") for r in range(world_size)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(
        r, world_size, backend, f"file://{init}",
        None if device is None else str(device), fn, tuple(args),
        dict(kwargs or {}), rets[r], gate))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank(s) {failed} failed (exit codes "
                                   f"{[procs[r].exitcode for r in failed]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running after "
                                   f"{timeout} s (a rank stuck in a "
                                   f"collective?)")
            time.sleep(0.02)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        out = []
        for path in rets:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# The GSPMD half: logical-axis rules, specs, and the mesh over ranks.
# ---------------------------------------------------------------------------

# Default rule table: FSDP over "data", tensor parallel over "model",
# batch over ("pod", "data"). ``None`` -> replicated.
DEFAULT_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    ("batch", ("pod", "data")),
    ("seq", None),                   # sequence kept local by default
    ("seq_shard", ("data",)),        # long-context cells shard sequence over data
    ("embed", None),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", None),
    ("mlp", ("model",)),
    ("expert", ("model",)),          # expert parallelism
    ("expert_mlp", None),
    ("fsdp", ("data",)),             # parameter FSDP axis
    ("layers", None),
    ("kv_pages", None),
    ("kv_hot", None),   # hot-ring W axis (sharded over model when kv_heads cannot)
    ("latent", None),
    ("state", None),
    ("expander", ("expander",)),     # fabric pool stack: one shard per device
)

Spec = Tuple[Any, ...]
# bytes of one collective call of ``Mesh``: a larger tensor goes in pieces,
# so gloo stages it through pinned host buffers of this size, reused,
# instead of pinning a new buffer as large as the tensor
COLLECTIVE_BYTES = 1 << 26


def rules_to_dict(rules: Sequence[Tuple[str, Optional[object]]]) -> dict:
    return {k: v for k, v in rules}


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Sequence[Tuple[str, Optional[object]]] = DEFAULT_RULES,
                    mesh_axes: Sequence[str] = ("data", "model")) -> Spec:
    """Map a tuple of logical axis names to a spec, dropping mesh axes that
    do not exist on the mesh (e.g. "pod" on the single-pod mesh) and any
    mesh axis an earlier dim took."""
    table = rules_to_dict(rules)
    out: List[Any] = []
    used: set = set()
    for name in logical_axes:
        phys = None if name is None else table.get(name, None)
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        keep = tuple(a for a in phys if a in mesh_axes and a not in used)
        used.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs (dicts and NamedTuples of
    spec tuples) and the trees that share its structure."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if not _is_spec(specs):          # a NamedTuple (the AdamState)
        return type(specs)(*(map_specs(fn, getattr(specs, f),
                                       *(getattr(t, f) for t in trees))
                             for f in specs._fields))
    return fn(specs, *trees)


def spec_leaves(specs, path: Tuple = ()):
    """(key path, spec) of every leaf of a tree of specs."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from spec_leaves(v, path + (k,))
    elif not _is_spec(specs):
        for f in specs._fields:
            yield from spec_leaves(getattr(specs, f), path + (f,))
    else:
        yield path, specs


def tree_specs(logical_tree,
               rules: Sequence[Tuple[str, Optional[object]]] = DEFAULT_RULES,
               mesh_axes: Sequence[str] = ("data", "model")):
    """A tree of logical-axis tuples mapped to specs (the reference's
    ``tree_shardings``)."""
    return map_specs(lambda axes: logical_to_spec(axes, rules, mesh_axes),
                     logical_tree)


def batch_spec(mesh, rules=DEFAULT_RULES) -> Spec:
    """The batch's spec on ``mesh`` (a ``Mesh`` or a ``MeshConfig``)."""
    return logical_to_spec(("batch", "seq"), rules, mesh.axes)


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def block_shape(full_shape, spec: Spec, sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``full_shape`` under
    ``spec`` on a mesh of axis ``sizes``; a dim that does not split evenly
    raises, as the reference's sharded arguments do."""
    out = list(full_shape)
    for d, e in enumerate(spec):
        n = int(np.prod([sizes[a] for a in _entry_axes(e)]))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(full_shape)} does not "
                             f"split {n} ways ({spec})")
        out[d] //= n
    return tuple(out)


class Mesh:
    """The world's ranks as a mesh of ``shape`` over ``axes``, row-major:
    rank r sits at ``np.unravel_index(r, shape)``. Every rank builds every
    process group (one for each row of each set of axes, in one order), so
    construct it on every rank. A collective over axes of size 1 is the
    identity and issues nothing; every rank must call the others in the
    same order."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 device):
        self.shape, self.axes = tuple(int(s) for s in shape), tuple(axes)
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes}")
        self.size = int(np.prod(self.shape))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} "
                             f"ranks; the world has {world}")
        self.rank, self.device = rank, torch.device(device)
        self.sizes = dict(zip(self.axes, self.shape))
        self.coord = dict(zip(self.axes, (int(c) for c in np.unravel_index(
            rank, self.shape))))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        live = [a for a in self.axes if self.sizes[a] > 1]
        for n in range(1, len(live)):
            for sub in itertools.combinations(live, n):
                others = [a for a in self.axes if a not in sub]
                for fixed in itertools.product(*(range(self.sizes[a])
                                                 for a in others)):
                    pos = dict(zip(others, fixed))
                    ranks = [int(np.ravel_multi_index(
                        [dict(pos, **dict(zip(sub, c)))[a]
                         for a in self.axes], self.shape))
                        for c in itertools.product(*(range(self.sizes[a])
                                                     for a in sub))]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        self._groups[sub] = g

    def _live(self, axes) -> Tuple[str, ...]:
        """``axes`` (names, or None for all) that have more than one rank,
        in the mesh's order."""
        axes = self.axes if axes is None else _entry_axes(axes)
        for a in axes:
            if a not in self.sizes:
                raise ValueError(f"no axis {a!r} on the mesh {self.axes}")
        return tuple(a for a in self.axes if a in axes and self.sizes[a] > 1)

    def axis_size(self, axes=None) -> int:
        return int(np.prod([self.sizes[a] for a in self._live(axes)]))

    def _pieces(self, x: torch.Tensor):
        """Views of the contiguous ``x``, flat, of COLLECTIVE_BYTES each."""
        flat = x.view(-1)
        n = max(COLLECTIVE_BYTES // x.element_size(), 1)
        return [flat[i:i + n] for i in range(0, flat.numel(), n)]

    def psum(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The sum of ``x`` over the ranks that differ only in ``axes``
        (None: the whole mesh); ``x`` itself where those axes are 1."""
        live = self._live(axes)
        if not live:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        for piece in self._pieces(y):
            dist.all_reduce(piece, group=self._groups.get(live))
        return y

    def spec_axes(self, spec: Spec) -> Tuple[str, ...]:
        """The axes of more than one rank that ``spec`` shards over."""
        return self._live(sum((_entry_axes(e) for e in spec), ()))

    def owns(self, spec: Spec) -> bool:
        """Whether this rank holds the first copy of its block of a leaf
        of ``spec``: coordinate 0 on every axis the spec does not shard
        over (a replicated value counted once in a sum over the mesh)."""
        held = self.spec_axes(spec)
        return all(self.coord[a] == 0 for a in self.axes if a not in held)

    def _ways(self, entry, coord=None) -> Tuple[int, int]:
        """(blocks, the block of the rank at ``coord``, default this one)
        of a dim sharded by ``entry``."""
        coord = self.coord if coord is None else coord
        n, i = 1, 0
        for a in _entry_axes(entry):
            n, i = n * self.sizes[a], i * self.sizes[a] + coord[a]
        return n, i

    def local_shape(self, full_shape, spec: Spec) -> Tuple[int, ...]:
        return block_shape(full_shape, spec, self.sizes)

    def full_shape(self, local_shape, spec: Spec) -> Tuple[int, ...]:
        out = list(local_shape)
        for d, e in enumerate(spec):
            out[d] *= self._ways(e)[0]
        return tuple(out)

    def _block(self, local_shape, spec: Spec, coord=None) -> tuple:
        out = []
        for d, e in enumerate(spec):
            i, n = self._ways(e, coord)[1], local_shape[d]
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def _members(self, live: Tuple[str, ...]):
        """(global rank, coordinate) of each rank of this rank's group over
        the axes ``live``, row-major."""
        for c in itertools.product(*(range(self.sizes[a]) for a in live)):
            coord = dict(self.coord, **dict(zip(live, c)))
            yield int(np.ravel_multi_index([coord[a] for a in self.axes],
                                           self.shape)), coord

    def shard(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the whole ``x`` (a copy of its own)."""
        if not self.spec_axes(spec):
            return x
        loc = self.local_shape(x.shape, spec)
        return x[self._block(loc, spec)].clone(
            memory_format=torch.contiguous_format)

    def gather(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole leaf from every rank's block ``x``: each rank of the
        group over the spec's axes broadcasts its block in turn."""
        live = self.spec_axes(spec)
        if not live:
            return x
        x = x.contiguous()
        full = torch.empty(self.full_shape(x.shape, spec), dtype=x.dtype,
                           device=x.device)
        buf = torch.empty_like(x)
        for src, coord in self._members(live):
            blk = x if src == self.rank else buf
            for piece in self._pieces(blk):
                dist.broadcast(piece, src=src, group=self._groups.get(live))
            full[self._block(x.shape, spec, coord)] = blk
        return full

    def scatter(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the sum of the whole ``x`` over the spec's
        axes (a reduce-scatter: a psum and the block)."""
        return self.shard(self.psum(x, self.spec_axes(spec)), spec)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


class TreeSharding:
    """A tree of specs on a mesh (the reference's tree of
    ``NamedSharding``s): ``shard`` takes whole leaves to this rank's
    blocks, ``gather`` blocks back to whole leaves (a collective: every
    rank calls it). Leaves that are not tensors (a compressed moment's
    host ``block``) pass through."""

    def __init__(self, mesh: Mesh, specs):
        self.mesh, self.specs = mesh, specs

    def shard(self, tree):
        return map_specs(lambda s, x: self.mesh.shard(x, s)
                         if isinstance(x, torch.Tensor) else x,
                         self.specs, tree)

    def gather(self, tree):
        return map_specs(lambda s, x: self.mesh.gather(x, s)
                         if isinstance(x, torch.Tensor) else x,
                         self.specs, tree)

    def spec(self, path) -> Spec:
        node = self.specs
        for k in path:
            node = getattr(node, k) if hasattr(node, "_fields") else node[k]
        return node

    @staticmethod
    def join(parts: Dict[str, "TreeSharding"]) -> "TreeSharding":
        """One sharding of ``{name: tree}`` from each tree's."""
        mesh = next(iter(parts.values())).mesh
        return TreeSharding(mesh, {k: v.specs for k, v in parts.items()})
