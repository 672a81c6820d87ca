"""The histogram kernel's plain version (``ops/hist_cuda._hist_reference``,
what ``hist_rows`` runs on a CPU tensor) held to the JAX package's Pallas
histogram kernel in interpret mode and to a numpy float64 loop, on the
cases ``tests/test_layout.py`` holds ``hist_pallas`` to: a ragged count,
junk past the count, gather/contiguous order invariance, u16 bins.

Tolerances: grad/hess within rtol 2e-3 / atol 1e-4 of ``hist_pallas`` (its
bf16 hi/lo channel split is ~f32-accurate, the bar tests/test_layout.py
sets it) and within rtol 1e-6 of the f64 loop (the plain version sums in
f64 and rounds once to f32); the count channel is exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdagap_tpu.ops.hist_pallas import hist_pallas, pack_gh8
from lambdagap_tpu_torch.ops import hist_cuda as hc


def _np_hist(bins, g, h, rows, count, B):
    F = bins.shape[1]
    ref = np.zeros((F, B, 3), np.float64)
    for p in range(count):
        i = p if rows is None else rows[p]
        for f in range(F):
            ref[f, bins[i, f]] += [g[i], h[i], 1.0]
    return ref


def _data(seed, P, F, B, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (P, F)).astype(dtype)
    g = rng.randn(P).astype(np.float32)
    h = np.abs(rng.randn(P)).astype(np.float32)
    return bins, g, h


def _plain(bins, g, h, rows, count, B):
    t = torch.from_numpy
    return hc.hist_rows(t(bins), t(g), t(h),
                        None if rows is None else t(rows.astype(np.int32)),
                        count, B).numpy()


def _pallas(bins, g, h, count, B):
    gh8 = pack_gh8(jnp.asarray(g), jnp.asarray(h), jnp.ones(len(g), bool))
    return np.asarray(hist_pallas(jnp.asarray(bins), gh8, B, count))


@pytest.mark.parametrize("P, F, B, count, seed", [
    (300, 5, 16, 257, 0),          # ragged final tile (test_layout.py:193)
    (256, 4, 8, 100, 1),
    (512, 6, 256, 512, 3),
])
def test_plain_matches_hist_pallas_and_f64(P, F, B, count, seed):
    bins, g, h = _data(seed, P, F, B)
    got = _plain(bins, g, h, None, count, B)
    ref = _np_hist(bins, g, h, None, count, B)
    pal = _pallas(bins, g, h, count, B)
    assert got.dtype == np.float32 and got.shape == (F, B, 3)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_array_equal(got[..., 2], pal[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pal, rtol=2e-3, atol=1e-4)


def test_plain_ignores_junk_past_count():
    """Row ids past the count are never read through: out-of-range ids
    there must not matter (test_layout.py:205's case, by row list)."""
    bins, g, h = _data(1, 256, 4, 8)
    rows = np.random.RandomState(5).permutation(256)
    junk = rows.copy()
    junk[100:] = 2 ** 31 - 1
    got = _plain(bins, g, h, junk, 100, 8)
    np.testing.assert_array_equal(got, _plain(bins, g, h, rows, 100, 8))
    np.testing.assert_allclose(got, _np_hist(bins, g, h, rows, 100, 8),
                               rtol=1e-6, atol=1e-6)
    pal = _pallas(bins[rows], g[rows], h[rows], 100, 8)
    np.testing.assert_allclose(got, pal, rtol=2e-3, atol=1e-4)


def test_plain_gather_equals_contiguous():
    """Rows gathered through a permutation and the same rows laid out
    contiguously give bit-identical histograms
    (test_layout.py:226's invariance)."""
    bins, g, h = _data(2, 512, 6, 16)
    perm = np.random.RandomState(2).permutation(512)
    gathered = _plain(bins, g, h, perm, 512, 16)
    contiguous = _plain(np.ascontiguousarray(bins[perm]), g[perm], h[perm],
                        None, 512, 16)
    np.testing.assert_array_equal(gathered, contiguous)


def test_plain_u16_bins_and_device_count():
    """u16 bins with more than 256 bins, a ragged count given as a
    one-element int32 tensor (how the learner passes it)."""
    bins, g, h = _data(4, 700, 3, 300, np.uint16)
    rows = np.random.RandomState(4).permutation(700)[:650]
    t = torch.from_numpy
    got = hc.hist_rows(t(bins), t(g), t(h), t(rows.astype(np.int32)),
                       torch.tensor([513], dtype=torch.int32), 300).numpy()
    ref = _np_hist(bins, g, h, rows, 513, 300)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    pal = _pallas(bins[rows], g[rows], h[rows], 513, 512)[:, :300]
    np.testing.assert_allclose(got, pal, rtol=2e-3, atol=1e-4)


def test_count_zero_is_empty():
    bins, g, h = _data(6, 64, 3, 8)
    assert not _plain(bins, g, h, None, 0, 8).any()


@pytest.mark.parametrize("bad, match", [
    (lambda b, g, h: (b.int(), g, h), "u8/u16"),
    (lambda b, g, h: (b, g.double(), h), "f32"),
    (lambda b, g, h: (b.T, g, h), "contiguous|f32"),
])
def test_wrapper_checks_inputs(bad, match):
    bins, g, h = (torch.from_numpy(a) for a in _data(7, 32, 4, 8))
    with pytest.raises((TypeError, ValueError), match=match):
        hc.hist_rows(*bad(bins, g, h), None, 32, 8)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel or raises."""
    bins, g, h = (torch.from_numpy(a).to("meta") for a in _data(8, 16, 2, 8))
    before = hc.HIST_LAUNCHES.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        hc.hist_rows(bins, g, h, None, 16, 8)
    assert hc.HIST_LAUNCHES.launches == before
