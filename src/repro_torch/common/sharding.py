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
spawn) with a ``file://`` rendezvous, runs ``fn(group, *args)`` on each and
returns what each returned; a rank that fails or a run past its time limit
stops every rank and raises. With a ``gate`` path the ranks start up (the
interpreter, the group, the device's context) and then wait for that file
to exist, so a caller can pay their start-up while it does other work.

The reference's GSPMD rule table (``DEFAULT_RULES``, ``logical_to_spec``)
belongs to the mesh training path and has no counterpart here (ROADMAP A.9).
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

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
                device, fn: Callable, args: Sequence, ret_path: str,
                gate: Optional[str]) -> None:
    torch.set_num_threads(1)
    group = init_expander_ranks(world, rank, backend, init_method, device)
    try:
        if gate is not None:
            torch.zeros((1,), device=group.device)    # the context, now
            while not os.path.exists(gate):
                time.sleep(0.01)
        out = fn(group, *args)
        with open(ret_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        leave_expander_ranks()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str,
                args: Sequence = (), device=None,
                workdir: Optional[str] = None, timeout: float = 600.0,
                gate: Optional[str] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks (``fn`` a
    module-level function, so each process can import it) and return the
    ranks' return values in rank order. ``device`` names every rank's
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
        None if device is None else str(device), fn, tuple(args), rets[r],
        gate))
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
