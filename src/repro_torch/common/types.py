"""Pool configuration for the PyTorch port.

A field-for-field copy of the reference ``PoolConfig`` (same names, defaults
and allowed values), so ``PoolConfig(**dataclasses.asdict(ref_cfg))`` builds
the port's config unchanged. On the port, ``compress_impl="jnp"`` names the
plain PyTorch compressor, ``"kernel"`` the CUDA kernels, and ``"auto"``
resolves by the tensor's device (core/compressor.py::resolve_impl).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
