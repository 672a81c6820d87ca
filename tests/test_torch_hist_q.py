"""The quantized-gradient path on the CPU, held exactly to the JAX
package: ``quantize_gradients`` (stochastic and deterministic) bit for bit
on the same numpy gradients and key, the K2 plain version
(``ops/hist_cuda._hist_q_reference``, what ``hist_rows_q`` runs on a CPU
tensor) ``array_equal`` to ``hist_pallas_q`` in interpret mode at
``tests/test_layout.py:249-263``'s shape, with a mask and with u16 bins,
the masked f32 plain version (``_hist_reference``) against a numpy
float64 loop (rtol 1e-6 / atol 1e-6: it sums 64-bit fixed-point integers
and rounds once; the count channel exactly), an offset into the row
list equal to slicing it, and a window of leaf-ordered copies (no row list,
tree_layout=sorted) exact against the JAX package's
``leaf_histogram_sorted``, ``hist_pallas_q`` and the gathered leaf."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdagap_tpu.ops import hist_pallas as hp
from lambdagap_tpu.ops.histogram import leaf_histogram_sorted
from lambdagap_tpu_torch.ops import hist_cuda as hc
from lambdagap_tpu_torch.utils import prng

t = torch.from_numpy


def _grads(seed, n):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 0.3).astype(np.float32)
    h = (np.abs(rng.randn(n)) * 0.2).astype(np.float32)
    return g, h


@pytest.mark.parametrize("qb", [2, 4, 16, 64, 127, 300])
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_gradients_equals_jax(qb, stochastic):
    g, h = _grads(qb, 1003)
    seed = 7919 + qb
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    kt = prng.split(prng.PRNGKey(seed))[1]
    ref = hp.quantize_gradients(jnp.asarray(g), jnp.asarray(h), kj, qb,
                                stochastic)
    got = hc.quantize_gradients(t(g), t(h), kt, qb, stochastic)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    half = max(min(qb, hc.MAX_QUANT_BINS) // 2, 1)
    assert np.abs(got[0].numpy()).max() <= half + 1


def test_quantize_zero_gradients_keeps_scales_finite():
    """All-zero gradients (a fully out-of-bag tree): the 1e-12 floor on
    the extrema keeps the scales finite, as in the JAX package."""
    z = np.zeros(64, np.float32)
    kj, kt = jax.random.PRNGKey(1), prng.PRNGKey(1)
    ref = hp.quantize_gradients(jnp.asarray(z), jnp.asarray(z), kj, 4)
    got = hc.quantize_gradients(t(z), t(z), kt, 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[0].any() and np.isfinite(got[2].item())


def _levels(seed, P, lo=-127, hi=128):
    rng = np.random.RandomState(seed)
    return (rng.randint(lo, hi, P).astype(np.int8),
            rng.randint(0, 128, P).astype(np.int8))


def _pallas_q(bins, gq, hq, mask, count, B):
    ghq8 = hp.pack_ghq8(jnp.asarray(gq), jnp.asarray(hq), jnp.asarray(mask))
    return np.asarray(hp.hist_pallas_q(jnp.asarray(bins), ghq8, B, count))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("count", [201, 300, 0])
def test_plain_q_equals_hist_pallas_q(masked, count):
    """test_layout.py:249-263's shape (300 x 5, 16 bins), plus a mask."""
    rng = np.random.RandomState(3)
    P, F, B = 300, 5, 16
    bins = rng.randint(0, B, (P, F)).astype(np.uint8)
    gq, hq = _levels(3, P)
    mask = rng.rand(P) < 0.7 if masked else np.ones(P, bool)
    ref = _pallas_q(bins, gq, hq, mask, count, B)
    got = hc.hist_rows_q(t(bins), t(gq), t(hq), None, count, B,
                         t(mask) if masked else None).numpy()
    assert got.dtype == np.int32 and got.shape == (F, B, 3)
    np.testing.assert_array_equal(got, ref)
    loop = np.zeros((F, B, 3), np.int64)
    for i in range(count):
        if mask[i]:
            for f in range(F):
                loop[f, bins[i, f]] += [gq[i], hq[i], 1]
    np.testing.assert_array_equal(got, loop)


def test_plain_q_holds_the_level_range_and_refuses_negative_hess():
    """The plain version at the ends of the levels K2 takes (g_q -128 and
    127, h_q 0 and 127, rows piled into one bin) equals a numpy int64 loop;
    a negative h_q, which K2's packed word cannot hold, is refused on the
    CPU."""
    rng = np.random.RandomState(13)
    P, F, B = 400, 3, 8
    bins = rng.randint(0, B, (P, F)).astype(np.uint8)
    bins[::2, 1] = 5
    gq = rng.choice(np.array([-128, 127], np.int8), P)
    hq = rng.choice(np.array([0, 127], np.int8), P)
    got = hc.hist_rows_q(t(bins), t(gq), t(hq), None, P, B).numpy()
    loop = np.zeros((F, B, 3), np.int64)
    for i in range(P):
        for f in range(F):
            loop[f, bins[i, f]] += [gq[i], hq[i], 1]
    np.testing.assert_array_equal(got, loop)
    hq[7] = -1
    with pytest.raises(ValueError, match="h_q"):
        hc.hist_rows_q(t(bins), t(gq), t(hq), None, P, B)


def test_plain_q_u16_bins_through_a_row_list():
    """u16 bins with more than 256 bins, gathered through a permutation
    with out-of-range junk past a device-style count."""
    rng = np.random.RandomState(4)
    P, F, B = 500, 3, 300
    bins = rng.randint(0, B, (P, F)).astype(np.uint16)
    gq, hq = _levels(4, P)
    mask = rng.rand(P) < 0.8
    rows = rng.permutation(P).astype(np.int32)
    junk = rows.copy()
    junk[333:] = 2**31 - 1
    got = hc.hist_rows_q(t(bins), t(gq), t(hq), t(junk),
                         torch.tensor([333], dtype=torch.int32), B,
                         t(mask)).numpy()
    ref = _pallas_q(bins[rows], gq[rows], hq[rows], mask[rows], 333, 512)
    np.testing.assert_array_equal(got, ref[:, :B])


def test_masked_plain_f32_equals_f64_loop():
    rng = np.random.RandomState(6)
    P, F, B = 400, 4, 32
    bins = rng.randint(0, B, (P, F)).astype(np.uint8)
    g, h = _grads(6, P)
    mask = rng.rand(P) < 0.6
    rows = rng.permutation(P).astype(np.int32)
    got = hc.hist_rows(t(bins), t(g), t(h), t(rows), 350, B,
                       t(mask)).numpy()
    ref = np.zeros((F, B, 3), np.float64)
    for p in range(350):
        i = rows[p]
        if mask[i]:
            for f in range(F):
                ref[f, bins[i, f]] += [g[i], h[i], 1.0]
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # an all-in mask is no mask
    np.testing.assert_array_equal(
        hc.hist_rows(t(bins), t(g), t(h), t(rows), 350, B,
                     torch.ones(P, dtype=torch.bool)).numpy(),
        hc.hist_rows(t(bins), t(g), t(h), t(rows), 350, B).numpy())


@pytest.mark.parametrize("bad, match", [
    (lambda b, g, h, m: (b, g.float(), h, m), "int8"),
    (lambda b, g, h, m: (b, g, h[:-1], m), "int8"),
    (lambda b, g, h, m: (b, g, h, m.to(torch.uint8)), "bool"),
    (lambda b, g, h, m: (b, g, h, m[:-1]), "bool"),
])
def test_q_wrapper_checks_inputs(bad, match):
    rng = np.random.RandomState(7)
    bins = t(rng.randint(0, 8, (32, 4)).astype(np.uint8))
    gq, hq = (t(a) for a in _levels(7, 32))
    mask = torch.ones(32, dtype=torch.bool)
    b, g, h, m = bad(bins, gq, hq, mask)
    with pytest.raises(TypeError, match=match):
        hc.hist_rows_q(b, g, h, None, 32, 8, m)


def test_q_non_cpu_tensor_never_takes_the_plain_version():
    rng = np.random.RandomState(8)
    bins = t(rng.randint(0, 8, (16, 2)).astype(np.uint8)).to("meta")
    gq, hq = (t(a).to("meta") for a in _levels(8, 16))
    before = hc.HIST_Q_LAUNCHES.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        hc.hist_rows_q(bins, gq, hq, None, 16, 8)
    assert hc.HIST_Q_LAUNCHES.launches == before


def test_exact_accum_limit_matches_jax():
    for impl in ("pallas", "onehot", "auto"):
        assert hc.exact_accum_limit(impl) == hp.exact_accum_limit(impl)
    assert hc.MAX_QUANT_BINS == hp.MAX_QUANT_BINS


def test_plain_q_offset_equals_slicing():
    """Position p reads rows[offset + p], as for hist_rows; junk outside
    [offset, offset + count) is never read through."""
    rng = np.random.RandomState(12)
    P, F, B = 500, 3, 16
    bins = t(rng.randint(0, B, (P, F)).astype(np.uint8))
    gq, hq = (t(a) for a in _levels(12, P))
    mask = t(rng.rand(P) < 0.75)
    rows = rng.permutation(P).astype(np.int32)
    for off, count in ((0, 200), (200, 300), (499, 1)):
        junk = rows.copy()
        junk[:off] = 2 ** 31 - 1
        junk[off + count:] = -5
        got = hc.hist_rows_q(bins, gq, hq, t(junk),
                             torch.tensor([count], dtype=torch.int32), B,
                             mask, torch.tensor([off], dtype=torch.int32))
        want = hc.hist_rows_q(bins, gq, hq, t(rows[off:off + count].copy()),
                              count, B, mask)
        assert torch.equal(got, want)


@pytest.mark.parametrize("begin, count", [(0, 300), (137, 250), (599, 1),
                                          (200, 0)])
def test_plain_q_window_matches_jax_sorted_and_hist_pallas_q(begin, count):
    """With no row list, position p reads row offset + p of the bins, the
    levels and the mask (tree_layout=sorted); the next leaf's rows past the
    count never count. Exact against the JAX package's
    ``leaf_histogram_sorted`` on the levels as f32 (integer sums far below
    2^24), ``hist_pallas_q`` in interpret mode on the window, and an int64
    loop."""
    rng = np.random.RandomState(16)
    N, F, B = 600, 4, 16
    bins = rng.randint(0, B, (N, F)).astype(np.uint8)
    gq, hq = _levels(16, N)
    mask = rng.rand(N) < 0.7
    got = hc.hist_rows_q(t(bins), t(gq), t(hq), None,
                         torch.tensor([count], dtype=torch.int32), B,
                         t(mask), torch.tensor([begin], dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (F, B, 3)
    got = got.numpy()
    loop = np.zeros((F, B, 3), np.int64)
    for i in range(begin, begin + count):
        if mask[i]:
            for f in range(F):
                loop[f, bins[i, f]] += [gq[i], hq[i], 1]
    np.testing.assert_array_equal(got, loop)
    gh = np.stack([gq, hq, mask], 1).astype(np.float32)
    js = np.asarray(leaf_histogram_sorted(
        jnp.asarray(bins), jnp.asarray(gh), jnp.int32(begin),
        jnp.int32(count), padded_size=1024, num_bins=B, precision="f32"))
    np.testing.assert_array_equal(got, js.astype(np.int64))
    win = slice(begin, N)
    np.testing.assert_array_equal(
        got, _pallas_q(bins[win], gq[win], hq[win], mask[win], count, B))


def test_plain_q_window_equals_the_gathered_leaf():
    """A leaf read as a window of the leaf-ordered copies equals the same
    leaf read through its slice of the permutation, u8 and u16 bins."""
    rng = np.random.RandomState(17)
    for dtype, B in ((np.uint8, 64), (np.uint16, 1024)):
        N, F = 700, 4
        bins = rng.randint(0, B, (N, F)).astype(dtype)
        gq, hq = _levels(17, N)
        mask = rng.rand(N) < 0.8
        perm = rng.permutation(N).astype(np.int32)
        for off, count in ((0, 300), (300, 400), (123, 45)):
            cnt = torch.tensor([count], dtype=torch.int32)
            o = torch.tensor([off], dtype=torch.int32)
            gathered = hc.hist_rows_q(t(bins), t(gq), t(hq), t(perm), cnt, B,
                                      t(mask), o)
            window = hc.hist_rows_q(t(bins[perm]), t(gq[perm]), t(hq[perm]),
                                    None, cnt, B, t(mask[perm]), o)
            assert torch.equal(window, gathered)
