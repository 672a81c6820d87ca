"""The histogram kernel's plain version (``ops/hist_cuda._hist_reference``,
what ``hist_rows`` runs on a CPU tensor) held to the JAX package's Pallas
histogram kernel in interpret mode and to a numpy float64 loop, on the
cases ``tests/test_layout.py`` holds ``hist_pallas`` to: a ragged count,
junk past the count, gather/contiguous order invariance, u16 bins; and the
fixed-point contract K1 shares with it: the sums do not depend on the
order of a leaf's rows, the scale exponents do not either, no sum
overflows, and an offset into the row list equals slicing it.

Tolerances: grad/hess within rtol 2e-3 / atol 1e-4 of ``hist_pallas`` (its
bf16 hi/lo channel split is ~f32-accurate, the bar tests/test_layout.py
sets it) and within rtol 1e-6 / atol 1e-6 of the f64 loop (the plain
version sums 64-bit fixed-point integers, each value within 2^-(k+1) of
its own, and rounds each sum to f32 once); the count channel is exact
everywhere.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
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


def _extreme(seed, P):
    """Gradients spanning 1e-30 to 1e3 in magnitude, both signs."""
    rng = np.random.RandomState(seed)
    g = (10.0 ** rng.uniform(-30, 3, P) * rng.choice([-1, 1], P))
    h = 10.0 ** rng.uniform(-30, 3, P)
    return g.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_is_equal_under_any_row_order(seed):
    """Integer sums do not depend on the order of the adds: any
    permutation of a leaf's row list gives the same bits, with a mask,
    on extreme gradients (float sums would differ in the last bits)."""
    rng = np.random.RandomState(seed)
    P, F, B = 900, 5, 16
    bins = rng.randint(0, B, (P, F)).astype(np.uint8)
    g, h = _extreme(seed, P)
    mask = torch.from_numpy(rng.rand(P) < 0.8)
    t = torch.from_numpy
    leaf = rng.permutation(P)[:700].astype(np.int32)
    ref = hc.hist_rows(t(bins), t(g), t(h), t(leaf), 700, B, mask)
    for k in range(4):
        shuffled = np.random.RandomState(100 + k).permutation(leaf)
        got = hc.hist_rows(t(bins), t(g), t(h), t(shuffled), 700, B, mask)
        assert torch.equal(got, ref)


def test_plain_extreme_gradients_and_one_bin_equal_f64():
    """Gradients from 1e-30 to 1e3 with negative values, once spread over
    the bins and once with every row in one bin, against the f64 loop."""
    P, F, B = 2000, 3, 8
    g, h = _extreme(7, P)
    rng = np.random.RandomState(7)
    for bins in (rng.randint(0, B, (P, F)).astype(np.uint8),
                 np.full((P, F), 5, np.uint8)):
        got = _plain(bins, g, h, None, P, B)
        ref = _np_hist(bins, g, h, None, P, B)
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("min_row_bits", [24, 0])
def test_scale_is_order_free_and_bounds_every_sum(min_row_bits, monkeypatch):
    """The exponents come from maxima and the row count only, so shuffled
    inputs give the same k; and at that k the largest possible sum (every
    row at the largest magnitude, all in one bin) stays below 2^62 — at
    the default floor of 2^24 rows and, with the floor taken away, at the
    tightest k the row count allows."""
    monkeypatch.setattr(hc, "_SCALE_MIN_ROW_BITS", min_row_bits)
    g, h = _extreme(3, 5000)
    t = torch.from_numpy
    k = hc.hist_scale(t(g), t(h))
    perm = np.random.RandomState(3).permutation(5000)
    assert torch.equal(hc.hist_scale(t(g[perm]), t(h[perm])), k)
    assert k.dtype == torch.int32 and k.shape == (2,)
    # the largest row count built here, one row short of a power of two,
    # each value the largest f32 below 1 (so e = 0 and n = 21)
    n = 2 ** 21 - 1
    want_k = 62 - max(21, min_row_bits)
    top = np.float32(np.nextafter(np.float32(1), np.float32(0)))
    for sign in (1, -1):
        gg = torch.full((n,), sign * top)
        hh = torch.full((n,), top)
        kk = hc.hist_scale(gg, hh)
        assert kk.tolist() == [want_k, want_k]
        exact = n * round(float(top) * 2.0 ** want_k)
        assert exact < 2 ** 62
        got = hc.hist_rows(torch.zeros((n, 1), dtype=torch.uint8), gg, hh,
                           None, n, 2)
        np.testing.assert_allclose(got[0, 0].double().numpy(),
                                   [sign * n * float(top), n * float(top),
                                    n], rtol=1e-7)


def test_offset_equals_slicing():
    """Position p reads rows[offset + p]: a leaf passed as its parent's
    slice with a device offset equals the sliced list, with junk outside
    [offset, offset + count)."""
    bins, g, h = _data(9, 600, 4, 16)
    rows = np.random.RandomState(9).permutation(600).astype(np.int32)
    t = torch.from_numpy
    mask = torch.from_numpy(np.random.RandomState(10).rand(600) < 0.7)
    for off, count in ((0, 250), (250, 350), (137, 1)):
        junk = rows.copy()
        junk[:off] = 2 ** 31 - 1
        junk[off + count:] = -5
        offset = torch.tensor([off], dtype=torch.int32)
        got = hc.hist_rows(t(bins), t(g), t(h), t(junk),
                           torch.tensor([count], dtype=torch.int32), 16,
                           mask, offset)
        want = hc.hist_rows(t(bins), t(g), t(h),
                            t(rows[off:off + count].copy()), count, 16, mask)
        assert torch.equal(got, want)


def test_offset_needs_a_row_list():
    bins, g, h = (torch.from_numpy(a) for a in _data(11, 32, 2, 8))
    with pytest.raises(TypeError, match="offset"):
        hc.hist_rows(bins, g, h, None, 32, 8,
                     offset=torch.zeros(1, dtype=torch.int32))
