"""Workload trace generators (numpy only) — a copy of the reference
package's ``simx/trace.py`` so the port needs nothing of it at run time,
with one change: Zipf ranks come from ``zipf`` (numpy 2.0's sampler), so a
trace is the same under every numpy version.

Each paper workload (Table 2) is modeled by memory intensity, write ratio,
locality (Zipf exponent over the page footprint + streaming fraction) and a
page-content model (zero / 4-bit / 8-bit / raw block mix). A trace is
(ospn[i], is_write[i], block[i]); every generator is a deterministic
function of its ``seed``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    wpki_ratio: float        # writes / (reads+writes)
    zipf_a: float            # locality: higher = hotter head
    stream_frac: float       # fraction of sequential-scan accesses
    footprint_pages: float   # footprint as a multiple of the promoted region
    zero_frac: float         # fraction of all-zero pages
    mix4: float              # fraction of 4-bit-compressible blocks
    mix8: float              # 8-bit; remainder raw


# Knobs derived from Table 2 RPKI/WPKI + Figs. 9-11 commentary.
WORKLOADS: Dict[str, WorkloadSpec] = {
    "bwaves":  WorkloadSpec("bwaves", 0.14, 0.9, 0.5, 0.8, 0.10, 0.55, 0.25),
    "mcf":     WorkloadSpec("mcf", 0.15, 0.8, 0.1, 2.5, 0.15, 0.60, 0.25),
    "parest":  WorkloadSpec("parest", 0.01, 1.1, 0.3, 0.6, 0.10, 0.55, 0.30),
    "lbm":     WorkloadSpec("lbm", 0.43, 0.7, 0.8, 1.2, 0.30, 0.10, 0.20),
    "omnetpp": WorkloadSpec("omnetpp", 0.32, 0.6, 0.1, 3.0, 0.10, 0.65, 0.25),
    "bfs":     WorkloadSpec("bfs", 0.06, 0.7, 0.3, 2.0, 0.25, 0.35, 0.30),
    "pr":      WorkloadSpec("pr", 0.02, 0.5, 0.2, 4.0, 0.10, 0.40, 0.35),
    "cc":      WorkloadSpec("cc", 0.10, 0.5, 0.2, 4.0, 0.10, 0.40, 0.35),
    "tc":      WorkloadSpec("tc", 0.41, 0.8, 0.3, 1.5, 0.25, 0.35, 0.30),
    "xsbench": WorkloadSpec("xsbench", 0.00, 0.6, 0.2, 2.5, 0.05, 0.45, 0.35),
}


def make_rates_table(spec: WorkloadSpec, n_pages: int, blocks: int = 4,
                     seed: int = 0) -> np.ndarray:
    """Per-page per-block rate codes (0 zero / 1 4-bit / 2 8-bit / 3 raw)."""
    rng = np.random.default_rng(seed)
    zero_page = rng.random(n_pages) < spec.zero_frac
    p_raw = max(0.0, 1.0 - spec.mix4 - spec.mix8)
    rates = rng.choice([1, 2, 3], size=(n_pages, blocks),
                       p=[spec.mix4, spec.mix8, p_raw])
    rates[zero_page] = 0
    # sprinkle zero blocks inside normal pages (stack/padding regions)
    zb = rng.random((n_pages, blocks)) < 0.08
    rates[zb & ~zero_page[:, None]] = 0
    return rates.astype(np.int32)


_RAND_INT_MAX = float(np.iinfo(np.int64).max)


def _zipf_one(rng: np.random.Generator, a: float) -> int:
    """One Zipf(a) draw by numpy 2.0's ``Generator.zipf`` rejection sampler,
    from the same stream of doubles. Later numpy (2.3 is one) draws U from
    a floored interval instead, which changes every draw for a < ~1.8 and
    so every trace: the port keeps 2.0's sampler, the one the reference's
    numbers were made with, whatever numpy is installed."""
    if a >= 1025:
        return 1
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    while True:
        u = 1.0 - rng.random()
        v = rng.random()
        try:
            x = math.floor(math.pow(u, -1.0 / am1))
        except OverflowError:       # C's pow gives inf: rejected
            continue
        if x > _RAND_INT_MAX or x < 1.0:
            continue
        t = math.pow(1.0 + 1.0 / x, am1)
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            return x


def zipf(rng: np.random.Generator, a: float, size=None):
    """``rng.zipf(a, size)`` as numpy 2.0 draws it (``_zipf_one``): an
    int64 array of ``size`` draws, or one int."""
    if size is None:
        return _zipf_one(rng, a)
    return np.asarray([_zipf_one(rng, a) for _ in range(size)], np.int64)


def make_trace(spec: WorkloadSpec, *, n_accesses: int, n_pages: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ospn, is_write, block) arrays. Pages are random-placed (paper §5:
    random OS page allocation), so OSPNs carry no spatial locality."""
    rng = np.random.default_rng(seed + 1)
    n_stream = int(n_accesses * spec.stream_frac)
    n_zipf = n_accesses - n_stream
    # zipf over a randomly permuted page ranking
    ranks = zipf(rng, max(spec.zipf_a, 1.01) + 1e-9, size=2 * n_zipf)
    ranks = ranks[ranks <= n_pages][:n_zipf]
    while ranks.shape[0] < n_zipf:
        extra = zipf(rng, max(spec.zipf_a, 1.01))
        ranks = np.append(ranks, extra if extra <= n_pages else 1)
    perm = rng.permutation(n_pages)
    zipf_pages = perm[(ranks - 1).astype(np.int64)]
    # streaming scan wraps the footprint
    start = rng.integers(0, n_pages)
    stream_pages = perm[(start + np.arange(n_stream)) % n_pages]
    pages = np.concatenate([zipf_pages, stream_pages])
    order = rng.permutation(n_accesses)
    pages = pages[order]
    is_write = rng.random(n_accesses) < spec.wpki_ratio
    block = rng.integers(0, 4, size=n_accesses)
    return (pages.astype(np.int32), is_write.astype(bool),
            block.astype(np.int32))


def make_block_content(rates: np.ndarray, vals: int,
                       seed: int = 0) -> np.ndarray:
    """Real payload for a rates table (the port's addition: the reference
    replays carry no data). ``rates`` [...] of rate codes -> float32
    [..., vals] blocks, every value exact in bf16, one class per code:

      0  all zeros
      1  an exact 4-bit grid: integers in [-7, 7], amax pinned to 7
      2  an exact 8-bit grid: integers in [-126, 126], amax pinned to 127
      3  random finite bf16 bit patterns

    Under lossless rate selection each block lands on its own code (a
    random-bits block passes 8-bit only by chance)."""
    rng = np.random.default_rng(seed)
    rates = np.asarray(rates)
    shape = rates.shape + (vals,)
    g4 = rng.integers(-7, 8, size=shape).astype(np.float32)
    g4[..., 0] = 7.0
    g8 = rng.integers(-126, 127, size=shape).astype(np.float32)
    g8[..., 0] = 127.0
    bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    exp_all_ones = ((bits >> 7) & 0xFF) == 0xFF
    bits = np.where(exp_all_ones, bits & ~np.uint32(1 << 7), bits)  # finite
    raw = (bits << 16).view(np.float32)
    r = rates[..., None]
    return np.where(r == 0, np.float32(0.0),
                    np.where(r == 1, g4, np.where(r == 2, g8, raw)))
