"""Counted host syncs.

In eager PyTorch every device->host read (``.item()``, ``.tolist()``,
``.cpu()``, ``int(t)``, ``bool(t)``) waits for the card. The port makes each
such read through this module, so a run can say how many syncs each window
and each slow access cost. ``SYNCS`` is the process-wide counter; callers
reset it before the run they measure and read it after.
"""
from __future__ import annotations

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
