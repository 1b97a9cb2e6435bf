"""Free-chunk lists (§4.1.1) as array stacks (PyTorch port of
``repro.core.freelist``).

``items`` holds free chunk indices and ``top`` (int32 0-d) is the head
register. The lists are mutated in place. Every pop and push is a host
decision, so each reads ``top`` through one counted sync; popping an
empty list returns -1, as in the reference.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.common import contracts


class FreeList(NamedTuple):
    items: torch.Tensor      # int32[capacity]
    top: torch.Tensor        # int32[] — number of free items (head register)

    @property
    def capacity(self) -> int:
        return self.items.shape[0]


def make_freelist(n: int, device) -> FreeList:
    return FreeList(items=torch.arange(n, dtype=torch.int32, device=device),
                    top=torch.tensor(n, dtype=torch.int32, device=device))


def free_count(fl: FreeList) -> int:
    return contracts.item(fl.top)


def pop(fl: FreeList) -> int:
    """Pop one index; -1 if empty."""
    return pop_n(fl, 1)[0]


def pop_n(fl: FreeList, k: int) -> List[int]:
    """Pop ``k`` indices (head first), -1 for each the list cannot give."""
    top = free_count(fl)
    take = max(min(k, top), 0)
    vals = []
    if take:
        vals = contracts.tolist(fl.items[top - take:top].flip(0))
        fl.top.fill_(top - take)
    return vals + [-1] * (k - take)


def push_n(fl: FreeList, idxs: List[int]) -> None:
    """Push every non-negative entry of ``idxs`` in order."""
    idxs = [i for i in idxs if i >= 0]
    if not idxs:
        return
    top = free_count(fl)
    for i in idxs:
        fl.items[min(max(top, 0), fl.capacity - 1)] = i
        top += 1
    fl.top.fill_(top)


def push(fl: FreeList, idx: int) -> None:
    push_n(fl, [idx])
