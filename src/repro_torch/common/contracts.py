"""Counted host syncs.

In eager PyTorch every device->host read (``.item()``, ``.tolist()``,
``.cpu()``, ``int(t)``, ``bool(t)``) waits for the card. The port makes each
such read through this module, so a run can say how many syncs each window
and each slow access cost. ``SYNCS`` is the process-wide counter; callers
reset it before the run they measure and read it after.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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


_ATTR = "__sync_contract__"


@dataclass(frozen=True)
class SyncContract:
    """Declared host-sync budget: at most ``fetches`` device->host fetch
    sites per ``syncs_per`` event (the reference's ``@sync_contract``).
    ``fetches=0`` declares a sync-free region (the port's counterpart of a
    jitted step): no device->host read at all."""
    syncs_per: str
    fetches: int = 1

    def expected_syncs(self, n_events: int) -> int:
        return n_events * self.fetches


def sync_contract(syncs_per: str, fetches: int = 1):
    """Annotate a function with its host-sync contract; returns it
    unchanged (no wrapper frame on the hot paths). The port's lint
    (``repro_torch.analysis``, rules R1 and R5) reads the decorator from
    source; ``verify_sync_counters`` checks measured counts against it."""
    if not isinstance(fetches, int) or fetches < 0:
        raise ValueError(f"fetches must be a non-negative int, got {fetches!r}")

    def attach(fn):
        setattr(fn, _ATTR, SyncContract(syncs_per=syncs_per, fetches=fetches))
        return fn
    return attach


def get_sync_contract(fn) -> Optional[SyncContract]:
    """The contract attached to ``fn`` (bound methods resolve through to
    the underlying function), or None when undeclared."""
    return getattr(fn, _ATTR, None)


def verify_sync_counters(fn, n_events: int, n_syncs: int,
                         what: str = "") -> SyncContract:
    """Runtime half of the contract: assert the measured sync count matches
    the budget ``fn`` declared (0 for a sync-free region). Raises
    AssertionError when ``fn`` declares no contract or when the counts
    disagree; returns the contract."""
    c = get_sync_contract(fn)
    name = getattr(fn, "__qualname__", repr(fn))
    assert c is not None, f"{name} declares no @sync_contract ({what})"
    expected = c.expected_syncs(n_events)
    assert n_syncs == expected, (
        f"{name}: measured {n_syncs} syncs over {n_events} {c.syncs_per}s, "
        f"contract declares {c.fetches} per {c.syncs_per} "
        f"(expected {expected}) {what}")
    return c
