"""Threefry-2x32 keys and draws, bit-identical to ``jax.random`` with
``jax_threefry_partitionable=True`` (the default of the JAX release the
reference runs on).

A key is a pair of uint32 words. The hash is written with ``+ & << >> | ^``
only, so one definition serves Python ints (the host-side key chain of the
clock's victim selection) and int64 tensors (vectorised draws); every sum is
masked back to 32 bits where uint32 arithmetic would wrap.

  * ``key(seed)``          = (0, seed)                     (``PRNGKey``)
  * ``split(k, n)[i]``     = threefry(k, (0, i))           (fold-like split)
  * ``fold_in(k, d)``      = threefry(k, (0, d))
  * ``random_bits(k, s)``  = xor of the two hash words of threefry(k, (0, i))
                             over the flat index i of shape ``s``
  * ``uniform``/``gumbel``/``categorical`` follow ``jax.random`` ("low"
    Gumbel mode: -log(-log(u)), u uniform in [tiny, 1)).
  * ``randint`` is ``jax.random.randint`` for int32 (two draws from
    ``split(k)``, JAX's multiply-and-remainder span rule in uint32, held in
    int64 and masked); ``normal`` is sqrt(2) * erfinv(u), u uniform in
    (-1, 1): the same u as JAX, but torch's ``erfinv`` and XLA's need not
    agree to the last bit.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.common.utils import U32

Key = Tuple[int, int]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & U32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on uint32 values held as Python
    ints or int64 tensors; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & U32
    x2 = (x2 + ks[1]) & U32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & U32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & U32
    return x1, x2


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return (0, seed & U32)


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k[0], k[1], 0, data & U32)


def split(k: Key, num: int = 2) -> List[Key]:
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def random_bits(k: Key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32))."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi = idx >> 32
    lo = idx & U32
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """float32 uniform in [minval, maxval), ``jax.random.uniform``'s
    mantissa construction."""
    bits = random_bits(k, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: Key, shape, device="cpu") -> torch.Tensor:
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(k, shape, tiny, 1.0, device)))


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax sample over the last axis (first index on ties)."""
    g = gumbel(k, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def randint(k: Key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """int32 uniform in [minval, maxval) (``jax.random.randint`` with JAX's
    default int32 dtype); maxval <= minval gives minval, as in JAX."""
    span = max(int(maxval) - int(minval), 1)
    if span >= 1 << 31 or not (-(1 << 31) <= minval < (1 << 31)):
        raise ValueError(f"randint over [{minval}, {maxval}): the port "
                         "takes int32 bounds and spans under 2**31")
    k1, k2 = split(k)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    # uint32 arithmetic: every product and sum wraps at 2**32
    mult = ((((1 << 16) % span) ** 2) & U32) % span
    off = ((((hi % span) * mult) & U32) + lo % span) & U32
    return (off % span + minval).to(torch.int32)


def normal(k: Key, shape, device="cpu") -> torch.Tensor:
    """float32 standard normal, ``jax.random.normal``'s construction."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, device)
    return torch.erfinv(u) * torch.tensor(np.sqrt(2), dtype=torch.float32,
                                          device=device)
