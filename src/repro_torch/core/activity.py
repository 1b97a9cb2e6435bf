"""Page-activity region + second-chance (clock) demotion engine (§4.4) —
PyTorch port of ``repro.core.activity``.

The clock hand scans 16-entry groups (one 64B fetch each): referenced
entries get a second chance (bit cleared); the first allocated,
unreferenced entry whose page is not resident in the metadata cache is the
victim; a group with allocated entries but no candidate picks one of its
non-resident allocated entries at random (Gumbel-argmax on the key chain).

The scan is a host loop: each group costs one counted sync (its 16 entries
and their cache probes, fetched together) and the key chain runs on the
host in Python ints (common/prng.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import contracts, prng
from repro_torch.core import mcache as mc
from repro_torch.core.metadata import (ACT_REFERENCED_BIT, act_allocated,
                                       act_ospn, act_pack, act_referenced)

GROUP = 16  # activity entries per 64B fetch
_REF = 1 << ACT_REFERENCED_BIT


class ScanResult(NamedTuple):
    hand: int
    victim_pidx: int         # P-chunk index, -1 if none found
    victim_ospn: int         # -1 if none
    used_random: bool
    groups_scanned: int      # traffic: 1 rd + 1 wr of 64B each


def clock_scan(activity: torch.Tensor, hand: int, cache: mc.MCache,
               rng: prng.Key, max_groups: int = 8,
               force: bool = False) -> ScanResult:
    """Scan from ``hand`` (updates ``activity`` in place). ``force`` widens
    the random fallback to cache-resident pages (the emergency path when
    the promoted region is exhausted)."""
    n_groups = activity.shape[0] // GROUP
    if n_groups == 0:
        raise ValueError("the activity region needs at least one group")
    found, victim, ospn, used_rnd, groups = False, -1, -1, False, 0
    while not found and groups < max_groups:
        start = ((hand // GROUP) % n_groups) * GROUP
        entries = activity[start:start + GROUP]
        probed = mc.probe(cache, act_ospn(entries))
        host = contracts.tolist(torch.stack([entries, probed.to(torch.int64)]))
        alloc = [act_allocated(e) == 1 for e in host[0]]
        ref = [act_referenced(e) == 1 for e in host[0]]
        eligible = [a and not r and not p
                    for a, r, p in zip(alloc, ref, host[1])]
        rnd_pool = [a and (not p or force) for a, p in zip(alloc, host[1])]
        rng, sub = prng.split(rng)
        if any(eligible):
            pick = eligible.index(True)
        elif any(rnd_pool):
            w = torch.tensor(rnd_pool, dtype=torch.float32)
            pick = int(prng.categorical(sub, torch.log(w + 1e-9)))
        found = any(eligible) or any(rnd_pool)
        used_rnd = not any(eligible) and any(rnd_pool)
        victim = start + pick if found else -1
        ospn = act_ospn(host[0][pick]) if found else -1
        # second chance: clear the referenced bits of allocated entries
        activity[start:start + GROUP] = torch.where(
            act_allocated(entries) == 1, entries & ~_REF, entries)
        hand += GROUP
        groups += 1
    return ScanResult(hand, victim, ospn, used_rnd, groups)


def mark_allocated(activity: torch.Tensor, pidx: int, ospn: int) -> None:
    """Allocate P-chunk ``pidx``'s entry (referenced=1 on arrival)."""
    activity[pidx] = act_pack(1, 1, ospn)


def mark_free(activity: torch.Tensor, pidx: int) -> None:
    activity[pidx] = 0


def lazy_touch(activity: torch.Tensor, pidx: torch.Tensor) -> None:
    """Set the referenced bit of entry ``pidx`` (0-d tensor; < 0 is a
    no-op) — the §4.4 lazy update on metadata-cache eviction."""
    safe = torch.clamp(pidx, min=0)
    e = activity[safe]
    activity[safe] = torch.where(pidx >= 0, e | _REF, e)
