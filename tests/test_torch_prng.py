"""The port's threefry (``utils/prng``) held bit for bit to ``jax.random``:
``PRNGKey``, ``split`` and ``uniform`` over several seeds — among them the
quantization key's ``data_random_seed + 7919`` and the default
``bagging_seed`` — and shapes, with ``jax_threefry_partitionable`` as the
installed jax sets it (on by default since jax 0.5)."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from lambdagap_tpu_torch.utils import prng

SEEDS = [0, 1, 3, 42, 7919, 7919 + 1, 2**31 - 1, -1, 2**32 + 5]


def test_jax_splits_keys_partitionably():
    """The bit streams below are the partitionable ones (prng.py:1156)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_jax(seed):
    key = prng.PRNGKey(seed)
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_equals_jax(seed, num):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for _ in range(3):          # a chain of splits, as the samplers take
        sj, st = jax.random.split(kj, num), prng.split(kt, num)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        kj, kt = sj[0], st[0]


@pytest.mark.parametrize("seed", [0, 3, 7919 + 17])
@pytest.mark.parametrize("shape", [1, 7, 1000, 1001, (3, 5), (2, 3, 7)])
def test_uniform_equals_jax(seed, shape):
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    kt = prng.split(prng.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(kj, (shape,) if isinstance(
        shape, int) else shape))
    got = prng.uniform(kt, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform_on_a_large_draw_equals_jax():
    """A draw the size of a bagging mask, whose counters fill many
    threefry blocks."""
    kj = jax.random.PRNGKey(3)
    kt = prng.PRNGKey(3)
    np.testing.assert_array_equal(prng.uniform(kt, 200_003).numpy(),
                                  np.asarray(jax.random.uniform(kj,
                                                                (200_003,))))


def test_a_key_has_two_words():
    with pytest.raises(ValueError, match="two words"):
        prng.split(torch.zeros(3, dtype=torch.int64))
