"""Deterministic, resumable, shardable synthetic data pipeline (the
reference's ``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): any rank, or a
replacement after a failure, regenerates exactly its shard of any step, and
the launcher's retry from a checkpoint replays the same data. The tokens
are the reference's bit for bit (``common/prng.py``'s threefry, ``randint``
in JAX's layout); the frontend models' embeddings go through ``erfinv`` and
agree within 1e-5 relative before their bf16 rounding.

The token stream mixes zero runs (padding), narrow-range spans (repetitive
text) and full-vocab spans (high entropy), so its pages exercise every rate
of the IBEX compressor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import torch

from repro_torch.common import prng
from repro_torch.common.types import ModelConfig
from repro_torch.common.utils import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zero_frac: float = 0.1          # fraction of padding (zero-run) spans
    narrow_frac: float = 0.5        # narrow-range "repetitive" spans
    narrow_width: int = 64
    span: int = 64


def _synth_tokens(key: prng.Key, batch: int, seq: int, vocab: int,
                  dcfg: DataConfig, device) -> torch.Tensor:
    nspan = -(-seq // dcfg.span)
    k1, k2, k3, k4 = prng.split(key, 4)
    kind = prng.uniform(k1, (batch, nspan), device=device)[:, :, None]
    base = prng.randint(k2, (batch, nspan), 0,
                        max(vocab - dcfg.narrow_width, 1), device)
    narrow = base[:, :, None] + prng.randint(
        k3, (batch, nspan, dcfg.span), 0, dcfg.narrow_width, device)
    wide = prng.randint(k4, (batch, nspan, dcfg.span), 0, vocab, device)

    def f32(x):     # the reference compares against float32 constants
        return torch.tensor(x, dtype=torch.float32, device=device)

    spans = torch.where(kind < f32(dcfg.zero_frac), torch.zeros_like(wide),
                        torch.where(kind < f32(dcfg.zero_frac +
                                               dcfg.narrow_frac),
                                    narrow, wide))
    return spans.reshape(batch, nspan * dcfg.span)[:, :seq] % vocab


def make_batch(cfg: ModelConfig, step: int, *, global_batch: int,
               seq_len: int, shard: int = 0, num_shards: int = 1,
               dcfg: DataConfig = DataConfig(),
               device=None) -> Dict[str, torch.Tensor]:
    """Batch for (step, shard) on ``device`` (the card unless the caller
    names another): int32 tokens and next-token labels, and bf16
    ``embeds`` for the frontend models."""
    if global_batch % num_shards:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{num_shards} shards")
    dev = resolve_device(device)
    b = global_batch // num_shards
    key = prng.fold_in(prng.fold_in(prng.key(dcfg.seed), step), shard)
    tokens = _synth_tokens(key, b, seq_len + 1, cfg.vocab_size, dcfg, dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.frontend != "none":
        batch["embeds"] = (prng.normal(prng.fold_in(key, 7),
                                       (b, seq_len, cfg.d_model), dev)
                           * 0.02).to(torch.bfloat16)
    return batch


def batch_iterator(cfg: ModelConfig, *, start_step: int, global_batch: int,
                   seq_len: int, shard: int = 0, num_shards: int = 1,
                   dcfg: DataConfig = DataConfig(),
                   device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, global_batch=global_batch,
                         seq_len=seq_len, shard=shard, num_shards=num_shards,
                         dcfg=dcfg, device=device)
        step += 1
