"""The port's training data (``data/pipeline.py``) and its PRNG draws
(``common/prng.py::randint``/``normal``) against the JAX package, from the
same seeds: tokens and labels ``==`` the reference's; ``randint`` ``==``
``jax.random.randint`` over spans 1, 64, 512, vocab-sized and ones that are
not powers of two; ``normal`` within 1e-5 relative to the larger of 1 and
the value (torch's and XLA's ``erfinv`` differ in the last bits, about
5.8e-6 at worst over 1.6e6 draws); the frontend models' bf16 embeddings
within one bf16 rounding step (2**-7 relative) of the reference's, a flip
being a value whose float32 lies at a rounding boundary."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data import pipeline as JP
from repro_torch.common import prng
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as TP

NORMAL_RTOL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("shape", [(17,), (3, 17), (2, 5, 64)])
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 64), (0, 512), (0, 128256),
                                   (0, 128192), (3, 1000), (-5, 70000),
                                   (5, 5), (7, 3), (0, 2 ** 31 - 1)])
def test_randint_is_jax_randint(shape, lo, hi):
    for seed in (0, 1, 12345):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                             lo, hi))
        got = prng.randint(prng.key(seed), shape, lo, hi).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_randint_refuses_spans_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.key(0), (4,), -(2 ** 31), 2 ** 31 - 1)


def test_normal_within_erfinv_tolerance():
    worst = 0.0
    for seed in range(8):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (200_000,)))
        got = prng.normal(prng.key(seed), (200_000,)).numpy()
        assert got.dtype == np.float32
        worst = max(worst, float(np.max(np.abs(got - want) /
                                        np.maximum(1.0, np.abs(want)))))
    assert worst <= NORMAL_RTOL, worst


CASES = [(0, 0, 1, 0.1), (7, 0, 2, 0.1), (7, 1, 2, 0.1), (3, 2, 4, 0.1),
         (0, 0, 1, 0.3), (11, 3, 4, 0.3)]


@pytest.mark.parametrize("step,shard,num_shards,zero_frac", CASES)
def test_make_batch_tokens_equal_reference(step, shard, num_shards,
                                           zero_frac):
    cfg, jcfg = get_reduced("llama3_8b"), jget_reduced("llama3_8b")
    kw = dict(global_batch=8, seq_len=100, shard=shard,
              num_shards=num_shards)
    want = JP.make_batch(jcfg, step, dcfg=JP.DataConfig(zero_frac=zero_frac),
                         **kw)
    got = TP.make_batch(cfg, step, dcfg=TP.DataConfig(zero_frac=zero_frac),
                        device="cpu", **kw)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["chameleon_34b", "musicgen_medium"])
def test_frontend_embeds_within_one_bf16_step(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    for step in (0, 5):
        want = JP.make_batch(jcfg, step, global_batch=4, seq_len=48)
        got = TP.make_batch(cfg, step, global_batch=4, seq_len=48,
                            device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert got["embeds"].dtype == torch.bfloat16
        w = np.asarray(want["embeds"]).astype(np.float32)
        g = got["embeds"].float().numpy()
        np.testing.assert_allclose(g, w, rtol=BF16_STEP, atol=0)
        assert np.mean(g != w) < 1e-3


def test_pipeline_deterministic_and_sharded():
    cfg = get_reduced("llama3_8b")
    kw = dict(global_batch=8, seq_len=64, num_shards=2, device="cpu")
    b1 = TP.make_batch(cfg, 7, shard=0, **kw)
    b2 = TP.make_batch(cfg, 7, shard=0, **kw)
    b3 = TP.make_batch(cfg, 7, shard=1, **kw)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 64)
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    it = TP.batch_iterator(cfg, start_step=7, global_batch=8, seq_len=64,
                           num_shards=2, device="cpu")
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert torch.equal(next(it)["tokens"],
                       TP.make_batch(cfg, 8, shard=0, **kw)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        TP.make_batch(cfg, 0, global_batch=6, seq_len=8, num_shards=4,
                      device="cpu")


def test_pipeline_mix_exercises_compressor():
    cfg = get_reduced("llama3_8b")
    b = TP.make_batch(cfg, 0, global_batch=8, seq_len=256,
                      dcfg=TP.DataConfig(zero_frac=0.3), device="cpu")
    frac_zero = float((b["tokens"] == 0).float().mean())
    assert 0.05 < frac_zero < 0.6


def test_make_batch_without_device_needs_cuda():
    cfg = get_reduced("llama3_8b")
    if torch.cuda.is_available():
        assert TP.make_batch(cfg, 0, global_batch=2, seq_len=8)[
            "tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.make_batch(cfg, 0, global_batch=2, seq_len=8)


def test_data_config_is_the_reference_s():
    assert dataclasses.asdict(TP.DataConfig()) == \
        dataclasses.asdict(JP.DataConfig())
