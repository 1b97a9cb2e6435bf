"""The CUDA kernels on the card: each against its plain PyTorch version,
byte for byte, and the payload pool's whole path with the kernels against
the plain compressor. Needs no JAX; every test carries the ``gpu`` marker
and skips where no card is present:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.common.types import PoolConfig
from repro_torch.core import compressor as comp
from repro_torch.core import engine as E
from repro_torch.core.engine import batch
from repro_torch.kernels import qpack
from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                    make_rates_table, make_trace)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _blocks(n: int, v: int) -> np.ndarray:
    """Rows of the four content classes plus +-0 mixes and normal values
    that are not exact in bf16."""
    rng = np.random.default_rng(v + n)
    x = make_block_content(np.arange(n) % 4, v, seed=v)
    x[4::6] = np.where(np.arange(v) % 3 == 0, np.float32(-0.0), x[4::6])
    x[5::6] = rng.standard_normal((len(x[5::6]), v)) * 0.7
    return x.astype(np.float32)


@pytest.mark.parametrize("v", [512, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("ze", [True, False])
def test_kernels_vs_plain(cuda, v, dtype, lossless, ze):
    x = torch.from_numpy(_blocks(67, v)).to(cuda).to(dtype)
    kw = dict(lossless=lossless, zero_elision=ze,
              quanta=comp.quanta_per_rate(v))
    e0 = qpack.fused_encode_launches
    got = qpack.fused_encode(x, **kw)
    want = qpack.fused_encode_plain(x, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out = qpack.fused_decode(got[0], got[1])
    ref = qpack.fused_decode_plain(got[0], got[1])
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert qpack.fused_encode_launches == e0 + 1


def test_whole_path_kernel_vs_plain(cuda):
    base = PoolConfig(n_pages=256, n_pchunks=32, n_cchunks=2048,
                      mcache_sets=8, mcache_ways=4, store_payload=True,
                      lossless=True, fused_demote="on")
    rates = make_rates_table(WORKLOADS["mcf"], 64, 4, seed=3)
    content = torch.from_numpy(make_block_content(rates, 512, seed=3)
                               .reshape(64, -1)).to(cuda).to(torch.bfloat16)
    trace = make_trace(WORKLOADS["mcf"], n_accesses=512, n_pages=64, seed=3)
    out = {}
    for impl in ("kernel", "jnp"):
        cfg = dataclasses.replace(base, compress_impl=impl)
        pol = E.POLICIES["ibex"]
        pool = E.make_pool(cfg, seed=3)
        assert pool.meta.device.type == "cuda"
        for i in range(content.shape[0]):
            E.host_write_page(pool, cfg, pol, i, content[i])
        batch.replay_trace(pool, cfg, pol, *trace)
        out[impl] = interop.pool_to_numpy(pool)
    for k in out["kernel"]:
        np.testing.assert_array_equal(out["kernel"][k], out["jnp"][k],
                                      err_msg=k)


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(qpack, "fused_encode_plain", boom)
    monkeypatch.setattr(qpack, "fused_decode_plain", boom)
    x = torch.zeros((4, 512), dtype=torch.bfloat16, device=cuda)
    dense, rates, _ = qpack.fused_encode(x)
    qpack.fused_decode(dense, rates)
    torch.cuda.synchronize()
