"""Placement layer: OSPA page -> expander routing (a copy of
``repro.fabric.placement``, numpy only; DESIGN.md §11).

Hyperscale CXL deployments interleave pages across several expanders, and
delivered bandwidth is dominated by how well that placement spreads traffic.
A ``Placement`` owns the page->expander map the fabric routes with:

  * ``StaticInterleave``  — stateless interleave by multiplicative page
    hash (the OS's random page allocation makes this near-uniform);
  * ``CapacityAware``     — sticky greedy: a page is pinned on first sight
    to the expander with the fewest pages assigned so far;
  * ``LocalityAffinity``  — contiguous OSPN ranges per expander (NUMA-style
    affinity: pages of one tenant/zone land together);
  * ``WeightedInterleave`` — hash interleave with per-expander weights; the
    skew knob for the fabric bench's sensitivity sweep.

All placements carry an *override* table written by the spill/migration
path (fabric/ops.py): once a page migrates, routing follows the override,
not the base rule. Routing is host-side numpy — partitioning happens before
the expanders' replay.
"""
from __future__ import annotations

import numpy as np

# Knuth multiplicative hash constant; OSPNs carry no spatial locality
# (random OS page placement) but the hash makes interleave robust to
# structured page-id patterns from synthetic traces too.
_HASH_MULT = np.uint64(2654435761)


class Placement:
    """Base: override table + routing; subclasses define ``assign``."""

    def __init__(self, n_expanders: int, n_pages: int):
        if n_expanders < 1:
            raise ValueError("n_expanders must be >= 1")
        self.n_expanders = n_expanders
        self.n_pages = n_pages
        # spill/migration overrides: -1 = follow the base rule
        self.overrides = np.full((n_pages,), -1, np.int32)
        # committed migration epochs (one per apply_epoch batch; the
        # segment scheduler's "one scatter per epoch" contract)
        self.epoch = 0

    def assign(self, ospns: np.ndarray) -> np.ndarray:
        """Base page->expander rule (int32[len(ospns)])."""
        raise NotImplementedError

    def route(self, ospns: np.ndarray) -> np.ndarray:
        """Effective routing: overrides first, base rule otherwise."""
        ospns = np.asarray(ospns, np.int64)
        base = self.assign(ospns)
        ov = self.overrides[ospns]
        return np.where(ov >= 0, ov, base).astype(np.int32)

    def override(self, ospns: np.ndarray, expander: int) -> None:
        """Pin migrated pages to their new expander (one destination)."""
        self.apply_epoch(ospns, np.full(len(np.atleast_1d(ospns)),
                                        expander, np.int32))

    def apply_epoch(self, ospns: np.ndarray, dests: np.ndarray) -> None:
        """Commit one migration epoch: pin each page to its destination in
        a SINGLE batched scatter (no per-page host writes — the segment
        scheduler's override-update contract, DESIGN.md §13). Bumps the
        epoch counter even for empty batches so the scheduler's
        epoch/sync accounting stays 1:1 with committed applies."""
        ospns = np.atleast_1d(np.asarray(ospns, np.int64))
        if len(ospns):
            self.overrides[ospns] = np.asarray(dests, np.int32)
        self.epoch += 1


class StaticInterleave(Placement):
    """Stateless interleave by page hash."""

    def assign(self, ospns: np.ndarray) -> np.ndarray:
        h = (np.asarray(ospns, np.uint64) * _HASH_MULT) >> np.uint64(16)
        return (h % np.uint64(self.n_expanders)).astype(np.int32)


class WeightedInterleave(Placement):
    """Hash interleave into per-expander probability buckets — the skew
    knob: ``weights=[0.8, 0.2/…]`` sends 80% of pages to expander 0."""

    def __init__(self, n_expanders: int, n_pages: int, weights):
        super().__init__(n_expanders, n_pages)
        w = np.asarray(weights, np.float64)
        if w.shape != (n_expanders,) or w.min() < 0 or w.sum() <= 0:
            raise ValueError(f"bad weights {weights}")
        self.cum = np.cumsum(w / w.sum())

    def assign(self, ospns: np.ndarray) -> np.ndarray:
        h = (np.asarray(ospns, np.uint64) * _HASH_MULT) >> np.uint64(16)
        u = (h % np.uint64(1 << 20)).astype(np.float64) / float(1 << 20)
        return np.searchsorted(self.cum, u, side="right").clip(
            0, self.n_expanders - 1).astype(np.int32)


class LocalityAffinity(Placement):
    """Contiguous OSPN ranges: expander = ospn * N // n_pages."""

    def assign(self, ospns: np.ndarray) -> np.ndarray:
        o = np.asarray(ospns, np.int64).clip(0, self.n_pages - 1)
        return (o * self.n_expanders // self.n_pages).astype(np.int32)


class CapacityAware(Placement):
    """Sticky greedy: first sight of a page pins it to the expander with
    the fewest pages assigned so far (deterministic: ties break to the
    lowest expander id). Models capacity-aware OS/fabric page allocation."""

    def __init__(self, n_expanders: int, n_pages: int):
        super().__init__(n_expanders, n_pages)
        self.page_to_exp = np.full((n_pages,), -1, np.int32)
        self.load = np.zeros((n_expanders,), np.int64)

    def assign(self, ospns: np.ndarray) -> np.ndarray:
        ospns = np.asarray(ospns, np.int64)
        # only each page's FIRST occurrence needs the sequential greedy
        # step; everything else is a table lookup
        uniq, first = np.unique(ospns, return_index=True)
        for o in uniq[np.argsort(first)]:
            if self.page_to_exp[o] < 0:
                e = int(np.argmin(self.load))
                self.page_to_exp[o] = e
                self.load[e] += 1
        return self.page_to_exp[ospns]


def make_placement(mode: str, n_expanders: int, n_pages: int,
                   weights=None) -> Placement:
    """CLI/bench factory: interleave | capacity | locality | weighted."""
    if mode == "interleave":
        return StaticInterleave(n_expanders, n_pages)
    if mode == "capacity":
        return CapacityAware(n_expanders, n_pages)
    if mode == "locality":
        return LocalityAffinity(n_expanders, n_pages)
    if mode == "weighted":
        return WeightedInterleave(n_expanders, n_pages, weights)
    raise ValueError(f"unknown placement mode {mode!r}")
