"""Set-associative LRU metadata-cache model (§4.1.2) — PyTorch port of
``repro.core.mcache``.

State: tags int32[sets, ways] (OSPN, -1 invalid) and age int32 (LRU stack
position, 0 = MRU). The functions update both tensors in place and issue
no host syncs.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class MCache(NamedTuple):
    tags: torch.Tensor    # int32[sets, ways]
    age: torch.Tensor     # int32[sets, ways]; 0 == MRU


def make_mcache(sets: int, ways: int, device) -> MCache:
    return MCache(
        tags=torch.full((sets, ways), -1, dtype=torch.int32, device=device),
        age=torch.arange(ways, dtype=torch.int32, device=device)
        .repeat(sets, 1))


def set_index(ospn, sets: int):
    """xor-fold hash of uint32 OSPN(s) (an int or an int tensor)."""
    x = ospn & 0xFFFFFFFF
    return (x ^ (x >> 13)) % sets


def access(mc: MCache, ospn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Touch ``ospn``: returns (hit, evicted_ospn) as 0-d tensors; evicted
    is -1 unless a valid entry was displaced. The way becomes MRU."""
    s = set_index(ospn, mc.tags.shape[0])
    tags = mc.tags[s].clone()
    age = mc.age[s].clone()
    match = tags == ospn
    hit = match.any()
    way = torch.where(hit, torch.argmax(match.to(torch.int32)),
                      torch.argmax(age))
    evicted = torch.where(hit, torch.full_like(tags[0], -1), tags[way])
    w_age = age[way]
    new_age = torch.where(age < w_age, age + 1, age)
    new_age[way] = 0
    tags[way] = ospn
    mc.tags[s] = tags
    mc.age[s] = new_age
    return hit, evicted


_BIG = 1 << 20   # "never selected" recency score


def access_window(mc: MCache, ospns: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Touch a window of W OSPNs at once. Returns (hits bool[W], evicted
    int32[sets, ways+W], -1 padded). Window-granular recency: every access
    probes the window-start state (an earlier touch in the window counts as
    a hit), and the set keeps the ``ways`` most recent of its existing
    entries and the window's touches (later touch = more recent)."""
    sets, ways = mc.tags.shape
    w = ospns.shape[0]
    dev = ospns.device
    ospns = ospns.to(torch.int32)
    s = set_index(ospns.to(torch.int64), sets)                        # [W]
    in0 = (mc.tags[s] == ospns[:, None]).any(dim=1)
    idx = torch.arange(w, device=dev)
    same = ospns[:, None] == ospns[None, :]
    dup = (same & (idx[None, :] < idx[:, None])).any(dim=1)
    hits = in0 | dup

    keep_w = ~(same & (idx[None, :] > idx[:, None])).any(dim=1)      # last touch
    set_ids = torch.arange(sets, device=dev)
    win_in_set = (s[None, :] == set_ids[:, None]) & keep_w[None, :]  # [sets, W]
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    win_tags = torch.where(win_in_set, ospns[None, :], neg1)
    win_score = torch.where(win_in_set, -(idx[None, :] + 1).to(torch.int32), big)
    touched = ((mc.tags[:, :, None] == win_tags[:, None, :]) &
               (win_tags[:, None, :] >= 0)).any(dim=2)               # [sets, ways]
    ex_valid = (mc.tags >= 0) & ~touched
    ex_tags = torch.where(ex_valid, mc.tags, neg1)
    ex_score = torch.where(ex_valid, mc.age, big)
    cand_tags = torch.cat([ex_tags, win_tags], dim=1)                 # [sets, ways+W]
    cand_score = torch.cat([ex_score, win_score], dim=1)
    order = torch.argsort(cand_score, dim=1, stable=True)
    ranked_tags = torch.gather(cand_tags, 1, order)
    ranked_score = torch.gather(cand_score, 1, order)
    mc.tags.copy_(torch.where(ranked_score[:, :ways] < _BIG,
                              ranked_tags[:, :ways], neg1))
    mc.age.copy_(torch.arange(ways, dtype=torch.int32, device=dev)
                 .repeat(sets, 1))
    evicted = torch.where(ranked_score >= _BIG, neg1, ranked_tags)
    evicted[:, :ways] = -1
    return hits, evicted


def probe(mc: MCache, ospns: torch.Tensor) -> torch.Tensor:
    """Non-destructive residency check of OSPN(s) (demotion engine)."""
    s = set_index(ospns.to(torch.int64), mc.tags.shape[0])
    return (mc.tags[s] == ospns[..., None].to(torch.int32)).any(dim=-1)


def invalidate(mc: MCache, ospn: int) -> None:
    s = set_index(ospn, mc.tags.shape[0])
    match = mc.tags[s] == ospn
    mc.tags[s] = torch.where(match, -1, mc.tags[s])
    mc.age[s] = torch.where(match, mc.age.shape[1] - 1, mc.age[s])
