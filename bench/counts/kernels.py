"""Bytes and operations of the kernels whose roofline share is read, and
the names they carry in the profiler's trace.

Each input byte is counted read once and each output byte written once;
work that depends on the data counts what these inputs need (B5 reads the
codes of each lane's compressed prefix only)."""
from __future__ import annotations

from typing import Iterable

from bench.counts import peaks

# B5, the decode attention over the compressed cache (csrc/kvc_attn.cu):
# the GQA kernel and MLA's latent kernels (the tensor-core route serves
# bf16 queries, the CUDA-core one float32 queries)
B5_KERNELS = ("kvc_split_kernel", "kvc_latent_tc_kernel", "kvc_latent_kernel")
# B3 and B4 of the optimizer's compressed moments (csrc/qpack_fixed.cu)
B3_KERNEL = "encode_kernel"
B4_KERNEL = "decode_kernel"
# ops a value (chip_smoke.py's ENCODE_OPS_PER_VALUE, DECODE_OPS_PER_VALUE)
ENCODE_OPS_PER_VALUE = 18
DECODE_OPS_PER_VALUE = 2


def is_b3(name: str) -> bool:
    return B3_KERNEL in name and "prefill" not in name


def is_b4(name: str) -> bool:
    return B4_KERNEL in name


def b5_gqa(lengths: Iterable[int], lanes: int, hq: int, hkv: int, d: int,
           bits: int):
    """(bytes, ops) of one GQA launch over ``lanes`` lanes whose
    compressed prefixes hold ``lengths`` tokens: K and V codes and scales
    of those tokens, q in bf16, the lengths, and the f32 partial (m, l,
    acc) written."""
    tok = sum(int(x) for x in lengths)
    dp = d * bits // 8
    nbytes = tok * hkv * 2 * (dp + 4) + lanes * hq * d * 2 + lanes * 4 + \
        lanes * hq * (d + 2) * 4
    return nbytes, 4 * tok * hq * d


def b5_latent(lengths: Iterable[int], lanes: int, heads: int, r: int,
              bits: int):
    """(bytes, ops) of one latent launch (the key and value of every head
    one latent row of ``r`` values a token), bf16 q."""
    tok = sum(int(x) for x in lengths)
    rp = r * bits // 8
    nbytes = tok * (rp + 4) + lanes * heads * r * 2 + lanes * 4 + \
        lanes * heads * (r + 2) * 4
    return nbytes, 4 * tok * heads * r


def b5_bound_s(cfg, lengths, lanes: int, bits: int) -> float:
    """The bound of one B5 launch of ``cfg``'s decode step: the GQA kernel
    computes on the CUDA cores (float32), the latent one on the tensor
    cores (bf16 q)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        nb, ops = b5_latent(lengths, lanes, cfg.num_heads,
                            m.kv_lora_rank + m.qk_rope_head_dim, bits)
        return peaks.bound_s(nb, ops, "bfloat16")
    nb, ops = b5_gqa(lengths, lanes, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim, bits)
    return peaks.bound_s(nb, ops, "float32")


def b3_encode(n: int, block: int = 512):
    """(bytes, ops) of encoding ``n`` float32 values into 8-bit codes and
    a float32 scale a block."""
    return n * 4 + n + n // block * 4, ENCODE_OPS_PER_VALUE * n


def b4_decode(n: int, block: int = 512):
    """(bytes, ops) of decoding ``n`` 8-bit codes back to float32."""
    return n + n // block * 4 + n * 4, DECODE_OPS_PER_VALUE * n


def moment_block(n: int, block: int) -> int:
    """The optimizer's block of a leaf of ``n`` values (``adamw._blk``):
    ``block`` where it divides the leaf, else the whole leaf."""
    return block if n % block == 0 and n >= block else n


def qpack_update_bound_s(leaf_numels: Iterable[int], block: int) -> float:
    """The bound of one update's B3 and B4 launches: each moment (m and
    sqrt(v)) of every leaf decoded once and encoded once. Every launch is
    bytes-bound, so the launches' bounds add up to the sum's."""
    total = 0.0
    for n in leaf_numels:
        b = moment_block(n, block)
        for nb, ops in (b3_encode(n, b), b4_decode(n, b)):
            total += 2 * peaks.bound_s(nb, ops, "float32")
    return total
