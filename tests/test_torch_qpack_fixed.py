"""The port's fixed-rate quantize/pack (B3) and its inverse (B4), plain
versions, held bit for bit against the reference's Pallas kernels
``qpack_encode_2d``/``qpack_decode_2d`` (interpret mode, through the
``kernels/ops.py`` wrappers) and against ``core/compressor.py``'s
``quantize_blocks``/``dequantize_blocks``; plus the reference fault C4 and
the port's impl switch."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcomp
from repro.kernels import ops as jops
from repro_torch.core import compressor as comp
from repro_torch.kernels import qpack

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _blocks(n_blocks: int, block: int, seed: int) -> np.ndarray:
    """float32 [n_blocks, block] cycling through zeros, .5 ties on the
    4-bit grid, 4- and 8-bit saturation at -8 / -128, mixed +-0, and
    normal values (not exact in bf16)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_blocks, block)) * 0.7).astype(np.float32)
    cls = np.arange(n_blocks) % 6
    x[cls == 0] = 0.0
    ties = cls == 1
    x[ties] = rng.integers(-7, 7, size=(int(ties.sum()), block)) + 0.5
    x[ties, 0] = 7.0
    x[cls == 2] = -8.0
    x[cls == 2, 0] = 7.0
    x[cls == 3] = -128.0
    x[cls == 3, 0] = 127.0
    pm = cls == 4
    x[pm] = np.where(np.arange(block) % 2 == 1, np.float32(-0.0),
                     np.float32(0.0))
    return x


def _inputs(block: int, dtype: str, seed: int):
    """A [3, 4, 2*block] tensor (leading shape kept) in both packages."""
    x = _blocks(24, block, seed).reshape(3, 4, 2 * block)
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    return xt, xj


def _eq(port: torch.Tensor, ref) -> bool:
    a = port.contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
        b = np.asarray(ref).view(np.int16)
    else:
        b = np.asarray(ref)
    return a.shape == b.shape and np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block", [64, 128, 512])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_matches_quantize_blocks(bits, block, dtype):
    xt, xj = _inputs(block, dtype, seed=bits * block)
    codes, scales = qpack.encode_plain(xt, bits, block)
    jc, js = jcomp.quantize_blocks(xj, bits, block)
    assert _eq(codes, jc) and _eq(scales, js)
    for out_t, out_j in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
        got = qpack.decode_plain(codes, scales, bits, block, out_t)
        want = jcomp.dequantize_blocks(jc, js, bits, block, out_j)
        assert _eq(got, want)


@pytest.mark.parametrize("bits,block,dtype", [
    (4, 64, "bf16"), (8, 128, "f32"), (4, 512, "f32"), (8, 512, "bf16")])
def test_plain_matches_pallas_interpret(bits, block, dtype):
    """Through ops.qpack_encode/qpack_decode, which group sub-256 blocks
    into 256-value rows and pad to the TPU tile; interpret mode off-TPU."""
    assert jops.INTERPRET
    xt, xj = _inputs(block, dtype, seed=7 + bits + block)
    codes, scales = qpack.encode_plain(xt, bits, block)
    jc, js = jops.qpack_encode(xj, bits=bits, block=block)
    assert _eq(codes, jc) and _eq(scales, js)
    got = qpack.decode_plain(codes, scales, bits, block, torch.float32)
    want = jops.qpack_decode(jc, js, bits=bits, block=block,
                             dtype=jnp.float32)
    assert _eq(got, want)


def test_ref_quantize_kernel_under_jit_crashes_c4():
    """Reference fault C4: ``quantize_blocks_fast(..., impl="kernel")``
    cannot be jitted (``ops.qpack_encode`` takes ``int()`` of a traced
    product), so a jitted lane demotion with quantize_impl="kernel"
    raises. Unjitted, the same call equals quantize_blocks, as the port's
    B3 plain version does."""
    x = jnp.asarray(_blocks(64, 64, 3).reshape(2, 16, 2, 64))
    fn = functools.partial(jcomp.quantize_blocks_fast, bits=8, block=64,
                           impl="kernel")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.jit(fn)(x)
    jc, js = fn(x)
    rc, rs = jcomp.quantize_blocks(x, 8, 64)
    assert np.array_equal(np.asarray(jc), np.asarray(rc))
    assert np.array_equal(np.asarray(js), np.asarray(rs))
    pc, ps = comp.quantize_blocks_fast(torch.from_numpy(np.array(x)), 8,
                                       64, impl="auto")
    assert _eq(pc, rc) and _eq(ps, rs)


def test_impl_switch_on_cpu():
    """"auto" and "jnp" run the plain version on CPU tensors; "kernel"
    raises there (a CPU tensor never reaches a kernel, and a CUDA tensor
    never falls back)."""
    xt, _ = _inputs(128, "f32", seed=11)
    want = qpack.encode_plain(xt, 4, 128)
    launches = qpack.encode_launches
    for impl in ("auto", "jnp"):
        got = comp.quantize_blocks_fast(xt, 4, 128, impl=impl)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        back = comp.dequantize_blocks(got[0], got[1], 4, 128, impl=impl)
        assert torch.equal(back, qpack.decode_plain(*want, 4, 128))
    assert torch.equal(qpack.encode(xt, 4, 128)[0], want[0])
    assert qpack.encode_launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        comp.quantize_blocks_fast(xt, 4, 128, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        comp.dequantize_blocks(*want, 4, 128, impl="kernel")
    with pytest.raises(ValueError):
        qpack.encode(xt, 4, 96)            # does not divide 256
