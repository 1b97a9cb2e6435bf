"""Configurations of the PyTorch port: pool, model and serving.

Field-for-field copies of the reference ``PoolConfig``, ``ModelConfig``,
``ServeConfig``, ``MeshConfig``, ``OptimizerConfig``, ``TrainConfig`` and
``ShapeConfig`` with its four shapes (same names, defaults and allowed values), so
``PoolConfig(**dataclasses.asdict(ref_cfg))`` builds the port's config
unchanged (``ServeConfig.from_reference`` does the same for the nested
serving config). On the port, ``compress_impl``/``quantize_impl="jnp"``
name the plain PyTorch versions, ``"kernel"`` the CUDA kernels, and
``"auto"`` resolves by the tensor's device (core/compressor.py). One field
is the port's own: ``ServeConfig.attn_impl`` switches the two attention
kernels the same way (the reference computes that attention in jnp).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PoolConfig:
    """Configuration of the IBEX compressed-memory pool.

    Paper constants (§4): 4KB page, 1KB block (co-location: 4/page), 512B
    C-chunk, 4KB P-chunk, 128B size quanta, 32B metadata entries, wr_cntr
    threshold 16, demotion watermark 256 free P-chunks.
    """
    n_pages: int = 1024                # logical (OSPA) pages tracked
    n_cchunks: int = 4096              # 512B chunks in compressed region
    n_pchunks: int = 256               # 4KB chunks in promoted region
    page_bytes: int = 4096
    block_bytes: int = 1024
    chunk_bytes: int = 512
    quantum_bytes: int = 128
    mcache_sets: int = 128
    mcache_ways: int = 16
    wr_thresh: int = 16
    demote_watermark: int = 8
    shadow: bool = True                # shadowed promotion (§4.5)
    coloc: bool = True                 # block co-location (§4.6)
    compact: bool = True               # metadata compaction (§4.7)
    zero_elision: bool = True
    store_payload: bool = True
    demote_cadence: str = "window"     # "window" | "access"
    tol4: float = 0.10
    tol8: float = 0.01
    lossless: bool = False             # exact roundtrip required for 4/8-bit rates
    compress_impl: str = "auto"        # "auto" | "kernel" | "jnp"
    fused_demote: str = "auto"         # "auto" | "on" | "off"

    @property
    def blocks_per_page(self) -> int:
        return self.page_bytes // self.block_bytes

    @property
    def chunks_per_page(self) -> int:
        return self.page_bytes // self.chunk_bytes

    @property
    def quanta_per_block(self) -> int:
        return self.block_bytes // self.quantum_bytes

    @property
    def vals_per_block(self) -> int:
        return self.block_bytes // 2   # bf16 values

    @property
    def vals_per_page(self) -> int:
        return self.page_bytes // 2


# ---------------------------------------------------------------------------
# Model architecture. The port serves the dense and MoE families with
# GQA/MHA or MLA attention, the SSM family (Mamba1) and the hybrid family
# (Mamba2 groups with shared GQA attention).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False
    dense_d_ff: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba1"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_kind: str = "gqa"             # gqa | mla | none
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0
    attn_shared_blocks: int = 2
    frontend: str = "none"             # "none" | "vq_image" | "encodec_audio"
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Parameter count (the reference's ``ModelConfig.param_count``,
        its approximations included: Mamba1's dt rank taken as d_in // 16
        and no conv or dt bias; Mamba2's layer without its conv bias,
        dt bias, A and norm, and the hybrid's shared blocks counted once
        each)."""
        if self.family != "ssm" and self.attn_kind not in ("gqa", "mla"):
            raise NotImplementedError(
                f"param_count of family {self.family!r} / attention "
                f"{self.attn_kind!r}: the port has GQA and MLA attention "
                "only")
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            ssm = self.ssm or SSMConfig()
            d_in = ssm.expand * d
            # in_proj (x, z), conv, x_proj (dt, B, C), dt_proj, out_proj,
            # A, D
            return n + L * (d * 2 * d_in + d_in * ssm.d_conv +
                            d_in * (2 * ssm.d_state + d_in // 16) +
                            (d_in // 16) * d_in + d_in * d +
                            d_in * ssm.d_state + d_in)
        if self.attn_kind == "mla" and self.mla is not None:
            m, h = self.mla, self.num_heads
            attn = d * m.q_lora_rank + \
                m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim) \
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
                m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + \
                h * m.v_head_dim * d
        else:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        if self.family == "moe" and self.moe is not None:
            mo = self.moe
            mlp = mo.num_experts * 3 * d * mo.expert_d_ff + d * mo.num_experts
            if mo.dense_residual:
                mlp += 3 * d * mo.dense_d_ff
        else:
            mlp = 3 * d * self.d_ff
        if self.family == "hybrid":
            # Mamba2 layers carry no MLP; the shared blocks do
            ssm = self.ssm or SSMConfig(kind="mamba2")
            d_in = ssm.expand * d
            nheads = d_in // ssm.headdim
            mixer = d * (2 * d_in + 2 * ssm.ngroups * ssm.d_state + nheads) \
                + d_in * ssm.d_conv + d_in * d + nheads
            uses = L // max(self.attn_period, 1) if self.attn_period else 0
            return n + L * mixer + \
                min(self.attn_shared_blocks, max(uses, 1)) * (attn + mlp)
        return n + L * (attn + mlp)

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: only its top-k experts count)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        mo = self.moe
        per_expert = 3 * self.d_model * mo.expert_d_ff
        return self.param_count() - \
            self.num_layers * (mo.num_experts - mo.top_k) * per_expert


@dataclass(frozen=True)
class ServeConfig:
    max_running: int = 8               # concurrently decoding requests
    max_resident: int = 32
    page_tokens: int = 64
    max_pages_per_seq: int = 64
    kv_rate_bits: int = 4              # compressed-pool KV rate (4 or 8)
    hot_window: int = 256              # uncompressed recent-token window
    attn_chunk: int = 2048             # kv chunk of the plain decode attention
    fused_dequant_attention: bool = True  # False = paper-faithful promote-then-read
    n_expanders: int = 1
    quantize_impl: str = "auto"        # "auto" | "kernel" | "jnp"
    pool: PoolConfig = field(default_factory=PoolConfig)
    # the port's own: "auto" | "kernel" | "plain" for the decode (B5) and
    # prefill (B6) attention kernels
    attn_impl: str = "auto"

    @classmethod
    def from_reference(cls, ref, **kw) -> "ServeConfig":
        """The port's config from a reference ``ServeConfig`` (or its
        ``dataclasses.asdict``), port-only fields from ``kw``."""
        d = dict(ref if isinstance(ref, dict) else dataclasses.asdict(ref))
        pool = d.pop("pool")
        return cls(pool=PoolConfig(**(pool if isinstance(pool, dict) else
                                      dataclasses.asdict(pool))), **d, **kw)


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")
    pipeline_stages: int = 0           # >0: map "pod" axis to pipeline stages

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # IBEX-compressed optimizer state (block-quantized moments)
    compress_state: bool = False
    state_block: int = 512
    moment_dtype: str = "float32"      # "float32" | "bfloat16" (uncompressed)
    # error-feedback int8 gradient compression for the DP all-reduce
    compress_grads: bool = False


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    microbatches: int = 1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
    log_every: int = 10


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
