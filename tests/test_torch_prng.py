"""The port's threefry PRNG against jax.random (partitionable threefry),
bit for bit, over seeded keys."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.common import prng  # noqa: E402

N_KEYS = 64


def _keys():
    rng = np.random.default_rng(7)
    return [tuple(int(v) for v in k)
            for k in rng.integers(0, 2 ** 32, size=(N_KEYS, 2), dtype=np.uint64)]


def _jkey(k):
    return jnp.asarray(np.array(k, np.uint32))


def test_threefry_partitionable_is_on():
    # the reference's PRNG layout this port reproduces
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_key_from_seed(seed):
    assert prng.key(seed) == tuple(int(v) for v in
                                   np.asarray(jax.random.PRNGKey(seed)))


def test_split_and_fold_in():
    for k in _keys():
        want = np.asarray(jax.random.split(_jkey(k), 3)).tolist()
        assert [list(s) for s in prng.split(k, 3)] == want
        for d in (0, 1, 5, 2 ** 32 - 1):
            got = prng.fold_in(k, d)
            assert list(got) == np.asarray(
                jax.random.fold_in(_jkey(k), np.uint32(d))).tolist()


def test_bits_and_uniform():
    tiny = float(np.finfo(np.float32).tiny)
    for k in _keys():
        want = np.asarray(jax.random.bits(_jkey(k), (3, 7), jnp.uint32))
        got = prng.random_bits(k, (3, 7)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)
        u = np.asarray(jax.random.uniform(_jkey(k), (16,), jnp.float32,
                                          minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(prng.uniform(k, (16,), tiny, 1.0)
                                      .numpy().view(np.uint32),
                                      u.view(np.uint32))


def test_categorical_clock_fallback_weights():
    """The clock's random fallback: argmax(log(w + 1e-9) + gumbel) over a
    16-entry group with 0/1 weights."""
    rng = np.random.default_rng(3)
    for k in _keys():
        w = (rng.random(16) < 0.5).astype(np.float32)
        w[rng.integers(16)] = 1.0
        want = int(jax.random.categorical(_jkey(k),
                                          jnp.log(jnp.asarray(w) + 1e-9)))
        got = int(prng.categorical(k, torch.log(torch.from_numpy(w) + 1e-9)))
        assert got == want
