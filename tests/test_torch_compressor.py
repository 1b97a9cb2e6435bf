"""The fused demote/promote pair (B1/B2) and the compressor around it,
against the reference: the plain PyTorch versions must be byte-identical to
the JAX Pallas kernels run in interpret mode and to the jnp oracle, over
both block widths, lossless on/off and zero elision on/off. The CUDA
kernels themselves are held against the plain versions on the card, in
test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common.types import PoolConfig as JConfig  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.kernels import qpack as jqp  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core import compressor as tcomp  # noqa: E402
from repro_torch.kernels import qpack as tqp  # noqa: E402
from repro_torch.simx.trace import make_block_content  # noqa: E402

RNG = np.random.default_rng(21)


def _edge_blocks(v: int) -> np.ndarray:
    """16 float32 rows, every value exact in bf16: all four content classes
    plus +-0 mixes, .5 ties, 4-bit saturation at -8 and 8-bit at -128, and
    small-magnitude rows."""
    rows = list(make_block_content(np.array([0, 1, 2, 3, 1, 2, 3, 3]), v,
                                   seed=int(RNG.integers(1 << 30))))
    pm = np.zeros(v, np.float32)
    pm[1::2] = -0.0
    rows.append(pm)
    mixed = rows[1].copy()
    mixed[3::7] = -0.0
    rows.append(mixed)
    ties = (RNG.integers(-7, 7, v) + 0.5).astype(np.float32)
    ties[0] = 7.0
    rows.append(ties)
    sat4 = np.full(v, -8.0, np.float32)
    sat4[0] = 7.0
    rows.append(sat4)
    sat8 = np.full(v, -128.0, np.float32)
    sat8[0] = 127.0
    rows.append(sat8)
    rows.append((RNG.standard_normal(v) * 1e-3).astype(np.float32))
    rows.append((RNG.standard_normal(v) * 0.7).astype(np.float32))
    rows.append(RNG.integers(-3, 4, v).astype(np.float32))
    x = np.stack(rows)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_in(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch_in(x, dtype):
    return torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                  else torch.float32)


CASES = [(v, dtype, lossless, ze)
         for v in (512, 2048) for dtype in ("bf16", "f32")
         for lossless in (True, False) for ze in (True, False)]


@pytest.mark.parametrize("v,dtype,lossless,ze", CASES)
def test_fused_plain_vs_pallas_interpret(v, dtype, lossless, ze):
    x = _edge_blocks(v)
    kw = dict(tol4=0.10, tol8=0.01, lossless=lossless, zero_elision=ze,
              quanta=tcomp.quanta_per_rate(v))
    jd, jr, jq = jqp.qpack_fused_encode_2d(_jax_in(x, dtype), interpret=True,
                                           **kw)
    td, tr, tq = tqp.fused_encode_plain(_torch_in(x, dtype), **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if lossless and ze:
        assert set(tr.tolist()) == {0, 1, 2, 3}
    jo = jqp.qpack_fused_decode_2d(jd, jr, interpret=True)
    to = tqp.fused_decode_plain(td, tr)
    np.testing.assert_array_equal(to.view(torch.int16).numpy(),
                                  np.asarray(jo).view(np.int16))


@pytest.mark.parametrize("coloc", [True, False])
@pytest.mark.parametrize("lossless", [True, False])
def test_encode_decode_pages_vs_oracle(coloc, lossless):
    """The port's page compressor (plain path) against the reference jnp
    oracle: bufs, rates, quanta, num_chunks and the decoded pages."""
    jcfg = JConfig(coloc=coloc, lossless=lossless, compress_impl="jnp")
    tcfg = PoolConfig(**dataclasses.asdict(jcfg))
    nb = jcfg.blocks_per_page if coloc else 1
    rates = RNG.integers(0, 4, size=(6, nb))
    xs = make_block_content(rates, jcfg.vals_per_page // nb, seed=3) \
        .reshape(6, jcfg.vals_per_page)
    xs[5] = (RNG.standard_normal(jcfg.vals_per_page) * 0.5).astype(np.float32)
    xj = jnp.asarray(xs).astype(jnp.bfloat16)
    xt = torch.from_numpy(xs).to(torch.bfloat16)
    ref = jcomp.encode_pages(xj, jcfg)
    got = tcomp.encode_pages(xt, tcfg)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tcomp.select_rate(xt.reshape(-1, jcfg.vals_per_page // nb), tcfg).numpy(),
        np.asarray(jcomp.select_rate(xj.reshape(-1, jcfg.vals_per_page // nb),
                                     jcfg)))
    dj = jcomp.decode_pages(ref[0], ref[1], jcfg)
    dt = tcomp.decode_pages(got[0], got[1], tcfg)
    np.testing.assert_array_equal(dt.view(torch.int16).numpy(),
                                  np.asarray(dj).view(np.int16))
    bj, rj, qj, nj = jcomp.encode_page(xj[0], jcfg)
    bt, rt, qt, nt = tcomp.encode_page(xt[0], tcfg)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(
        tcomp.decode_page(bt, rt, tcfg).view(torch.int16).numpy(),
        np.asarray(jcomp.decode_page(bj, rj, jcfg)).view(np.int16))


@pytest.mark.parametrize("vals", [512, 2048, 256])
def test_quanta_table_and_page_bytes(vals):
    assert tcomp.quanta_per_rate(vals) == jcomp.quanta_per_rate(vals)
    for rates in ([0, 1, 2, 3], [3, 3, 3, 3], [1, 1, 0, 2]):
        assert tcomp.page_compressed_bytes(rates, vals) == int(
            jcomp.page_compressed_bytes(jnp.asarray(rates), vals))


def test_resolve_impl_by_device():
    assert tcomp.resolve_impl(PoolConfig(), "cpu") == "jnp"
    assert tcomp.resolve_impl(PoolConfig(compress_impl="jnp"), "cpu") == "jnp"
    assert tcomp.resolve_impl(PoolConfig(), "cuda") == "kernel"
    assert tcomp.resolve_impl(PoolConfig(compress_impl="jnp"), "cuda") == "jnp"
    with pytest.raises(ValueError):
        tcomp.resolve_impl(PoolConfig(compress_impl="kernel"), "cpu")
    with pytest.raises(ValueError):
        tcomp.resolve_impl(PoolConfig(compress_impl="pallas"), "cpu")


def test_config_copy_keeps_every_field():
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    port = {f.name: f.default for f in dataclasses.fields(PoolConfig)}
    assert ref == port
    cfg = JConfig(n_pages=7, coloc=False, lossless=True, fused_demote="on")
    assert dataclasses.asdict(PoolConfig(**dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    x = torch.from_numpy(_edge_blocks(512)).to(torch.bfloat16)
    e0, d0 = tqp.fused_encode_launches, tqp.fused_decode_launches
    dense, rates, quanta = tqp.fused_encode(x, lossless=True)
    ref = tqp.fused_encode_plain(x, lossless=True)
    for a, b in zip((dense, rates, quanta), ref):
        assert torch.equal(a, b)
    assert torch.equal(tqp.fused_decode(dense, rates),
                       tqp.fused_decode_plain(dense, rates))
    assert (tqp.fused_encode_launches, tqp.fused_decode_launches) == (e0, d0)
    with pytest.raises(ValueError):
        tqp.fused_encode(x.to(torch.int32))
