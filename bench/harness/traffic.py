"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and the seed, and gives a serve cell its
requests and a train cell its batches.

Serve mixes: request k has a prompt length and an output length taken from
a pool that every seed shares. The pool is made of strata of ``stratum``
requests; each stratum holds the same lengths (the distribution's
quantiles at (i + 0.5) / stratum, clipped), and the seed only orders
prompt and output lengths within each stratum, independently. So every
seed offers the same set of sizes, in another order, and any run of
requests follows the distribution closely. Prompt ids are uniform over
``[0, vocab)``, drawn from (seed, k).

Train mixes: batch i is the i-th draw of a device generator seeded from the
seed: ``batch`` rows of ``seq_len + 1`` uniform ids, shifted into tokens
and labels. Every row of every step differs.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np
import torch


def quantiles(dist: Dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist``: a
    lognormal of median ``median`` and log-sd ``sigma``, clipped to
    [min, max] and rounded."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


class ServeTraffic:
    """Requests of a serve mix for one seed, by global index."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        self.n = int(mix["stratum"])
        self._p = quantiles(mix["prompt"], self.n)
        self._o = quantiles(mix["output"], self.n)
        self._strata: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _stratum(self, s: int):
        got = self._strata.get(s)
        if got is None:
            rng = np.random.default_rng([self.seed, 1, s])
            got = (rng.permutation(self._p), rng.permutation(self._o))
            self._strata[s] = got
        return got

    def lengths(self, k: int) -> Tuple[int, int]:
        p, o = self._stratum(k // self.n)
        return int(p[k % self.n]), int(o[k % self.n])

    def request(self, k: int) -> Tuple[List[int], int]:
        """(prompt ids, max new tokens) of request k."""
        plen, olen = self.lengths(k)
        rng = np.random.default_rng([self.seed, 2, k])
        return rng.integers(0, self.vocab, plen).tolist(), olen


class TrainFeed:
    """Batches of a train mix for one seed, drawn on the device."""

    def __init__(self, mix: Dict, vocab: int, seed: int, device):
        self.rows, self.seq = int(mix["batch"]), int(mix["seq_len"])
        self.vocab, self.device = int(vocab), device
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 0x9E3779B97F4A7C15 + 7) % (2 ** 63 - 1))

    def next(self) -> Dict[str, torch.Tensor]:
        ids = torch.randint(0, self.vocab, (self.rows, self.seq + 1),
                            generator=self.gen, dtype=torch.int64,
                            device=self.device).to(torch.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq
