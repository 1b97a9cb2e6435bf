"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the reference's ``repro.optim.gradcomp``).

The all-reduce would move int8 codes and per-block f32 scales instead of f32
gradients, about 3.9x fewer bytes; each device's quantization residual is
carried into the next step (error feedback), which keeps SGD and Adam
unbiased to first order [Seide et al. 2014; Karimireddy et al. 2019]. The
codes go through B3 ``encode`` and back through B4 ``decode`` (the CUDA
kernels for CUDA tensors, unless ``impl`` names the plain version).
``train/trainer.py::make_dp_compressed_step`` runs them across ranks.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.common import tree as TR
from repro_torch.core.compressor import dequantize_blocks, quantize_blocks_fast

Tree = Any


def _block_for(n: int, block: int) -> int:
    return block if n % block == 0 and n >= block else n


def compress_leaf(g: torch.Tensor, block: int, impl: str = "auto"):
    flat = g.to(torch.float32).reshape(-1)
    b = _block_for(flat.numel(), block)
    codes, scales = quantize_blocks_fast(flat, 8, b, impl)
    return {"codes": codes, "scales": scales}


def decompress_leaf(c, shape, block: int, impl: str = "auto") -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    b = _block_for(n, block)
    return dequantize_blocks(c["codes"], c["scales"], 8, b, torch.float32,
                             impl).reshape(shape)


def compress_with_feedback(grads: Tree, residual: Tree, block: int = 512
                           ) -> Tuple[Tree, Tree]:
    """Returns (quantized grads tree, new residual tree)."""
    def one(g, r):
        corrected = g.to(torch.float32) + r
        c = compress_leaf(corrected, block)
        return c, corrected - decompress_leaf(c, g.shape, block)
    out = TR.map_tree(one, grads, residual)     # (codes, residual) a leaf
    return (TR.map_tree(lambda g, o: o[0], grads, out),
            TR.map_tree(lambda g, o: o[1], grads, out))


def decompress(qgrads: Tree, like: Tree, block: int = 512) -> Tree:
    return TR.map_tree(lambda l, q: decompress_leaf(q, l.shape, block),
                       like, qgrads)


def init_residual(params: Tree) -> Tree:
    return TR.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def compressed_bytes(qgrads: Tree) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in TR.leaves_with_paths(qgrads))
