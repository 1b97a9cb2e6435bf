"""Counted host syncs.

In eager PyTorch every device->host read (``.item()``, ``.tolist()``,
``.cpu()``, ``int(t)``, ``bool(t)``) waits for the card. The port makes each
such read through this module, so a run can say how many syncs each window
and each slow access cost. ``SYNCS`` is the process-wide counter; callers
reset it before the run they measure and read it after.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


class SyncCounter:
    """Number of device->host reads since the last ``reset``."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


SYNCS = SyncCounter()


def item(t: torch.Tensor):
    """``t.item()``, counted: the Python scalar of a one-element tensor."""
    SYNCS.count += 1
    return t.item()


def tolist(t: torch.Tensor) -> list:
    """``t.tolist()``, counted as one sync."""
    SYNCS.count += 1
    return t.tolist()


def upload(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values -> a tensor on ``device`` without a device sync: the
    source is pageable memory, which CUDA stages before the call returns."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def fetch(tree):
    """Host copies of a tensor, or of a dict of tensors, counted as ONE
    sync: the first copy waits for the card, the rest copy what is done."""
    SYNCS.count += 1
    if isinstance(tree, dict):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def fetch_packed(tree: dict) -> dict:
    """Host copies of a dict of tensors on one device in ONE device->host
    copy, counted as one sync: their bytes are concatenated on the device
    (widest dtype first, so every piece stays aligned) and split again on
    the host."""
    SYNCS.count += 1
    items = sorted(((k, v.detach().contiguous()) for k, v in tree.items()),
                   key=lambda kv: -kv[1].element_size())
    flat = torch.cat([v.reshape(-1).view(torch.uint8) for _, v in items]) \
        .to("cpu")
    out, o = {}, 0
    for k, v in items:
        n = v.numel() * v.element_size()
        out[k] = flat[o:o + n].view(v.dtype).reshape(v.shape)
        o += n
    return out


@dataclass(frozen=True)
class SyncContract:
    """Declared host-sync budget: at most ``fetches`` device->host fetch
    sites per ``syncs_per`` event (the reference's ``@sync_contract``)."""
    syncs_per: str
    fetches: int = 1


def sync_contract(syncs_per: str, fetches: int = 1):
    """Annotate a function with its host-sync contract; returns it
    unchanged. The repo's lint (rule R5) reads the decorator from source;
    ``verify_sync_counters`` checks measured counts against it."""
    def attach(fn):
        fn.__sync_contract__ = SyncContract(syncs_per, fetches)
        return fn
    return attach


def verify_sync_counters(fn, n_events: int, n_syncs: int) -> SyncContract:
    """Assert the measured sync count matches the budget ``fn`` declared."""
    c = getattr(fn, "__sync_contract__", None)
    assert c is not None, f"{fn.__qualname__} declares no @sync_contract"
    assert n_syncs == n_events * c.fetches, (
        f"{fn.__qualname__}: {n_syncs} syncs over {n_events} "
        f"{c.syncs_per}s, contract {c.fetches} per {c.syncs_per}")
    return c
