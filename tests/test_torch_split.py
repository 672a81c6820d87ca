"""The split scan and the partition of the port held to the JAX package's
``ops/split.py`` and ``ops/partition.py`` on random histograms and bins
made with numpy seeds.

Picks (feature, threshold, default_left, bitset) are equal and the
go-left masks and partitioned permutations are ``array_equal``. Gains and
leaf outputs are within rtol 1e-5: both sides compute them in f32, but the
JAX package's cumulative sums run as a parallel scan on the CPU backend and
the port's as a sequential one, so the last bits differ. Every bin of
these histograms holds rows, so no two thresholds split the rows the same
way (an exact tie is broken by those last bits). A feature without a
missing type scans the same split in both directions (equal gains up to
those bits), so its ``default_left`` — which routes no row — is not
compared. Likewise a categorical prefix of the sorted bins and the suffix
after it are one split with the sides swapped: where the scan picked the
mirror, the bitset is the complement over the feature's populated bins and
the left sums are the parent's minus the other side's.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdagap_tpu.ops import partition as jpart
from lambdagap_tpu.ops import split as jsplit
from lambdagap_tpu_torch.ops import partition as ppart
from lambdagap_tpu_torch.ops import split as psplit

PARAMS = [
    {},
    {"lambda_l1": 0.7, "lambda_l2": 3.0},
    {"max_delta_step": 0.4, "min_data_in_leaf": 40},
    {"path_smooth": 5.0, "min_sum_hessian_in_leaf": 2.0},
    {"min_gain_to_split": 1.5, "max_cat_to_onehot": 8,
     "max_cat_threshold": 5},
]


def _case(seed, F=7, B=32, hist_seed=None):
    """A random leaf: per-feature metadata from ``seed``, the histogram
    from ``hist_seed`` (default: the same seed)."""
    rng = np.random.RandomState(seed)
    num_bins = rng.randint(6, B + 1, F).astype(np.int32)
    missing = rng.randint(0, 3, F).astype(np.int32)
    default = np.array([rng.randint(0, nb - 1) for nb in num_bins], np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[[1, 4]] = True
    missing[is_cat] = 0
    if hist_seed is not None:
        rng = np.random.RandomState(hist_seed)
    cnt = rng.randint(1, 60, (F, B)).astype(np.float32)
    cnt[np.arange(B)[None, :] >= num_bins[:, None]] = 0.0
    g = (rng.randn(F, B) * cnt).astype(np.float32)
    h = (rng.rand(F, B) * cnt + 0.01 * cnt).astype(np.float32)
    hist = np.stack([g, h, cnt], -1)
    # every feature sees the same rows: take feature 0's totals
    for f in range(1, F):
        scale = hist[0, :, :].sum(0) / hist[f, :, :].sum(0)
        hist[f] *= scale[None, :]
    tot = hist[0].sum(0)
    fmask = np.ones(F, bool)
    fmask[5] = False
    return hist.astype(np.float32), tot, num_bins, default, missing, \
        is_cat, fmask


def _bits_set(words):
    words = np.asarray(words).astype(np.uint32)
    return {b for b in range(32 * len(words))
            if (int(words[b // 32]) >> (b % 32)) & 1}


def _cat_side(got_bits, want_bits, hist_f):
    """1 when the port's bitset is JAX's, -1 when it is its mirror over the
    feature's populated bins."""
    got, want = _bits_set(got_bits), _bits_set(want_bits)
    if got == want:
        return 1
    assert got == set(np.nonzero(hist_f[:, 2] > 0)[0]) - want
    return -1


def _jax_args(hist, tot, nb, db, mt, cat, fm):
    return (jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
            jnp.float32(tot[2]), jnp.float32(0.1), jnp.asarray(nb),
            jnp.asarray(db), jnp.asarray(mt), jnp.asarray(cat),
            jnp.asarray(fm))


def _port_args(hist, tot, nb, db, mt, cat, fm):
    t = torch.from_numpy
    return (t(hist), torch.tensor(tot[0]), torch.tensor(tot[1]),
            torch.tensor(tot[2]), torch.tensor(0.1, dtype=torch.float32),
            t(nb).long(), t(db).long(), t(mt).long(), t(cat), t(fm))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("params", PARAMS)
def test_per_feature_best_equals_jax(seed, params):
    case = _case(seed)
    jp, pp = jsplit.SplitParams(**params), psplit.SplitParams(**params)
    ref = [np.asarray(a) for a in jsplit.per_feature_best(
        *_jax_args(*case), jp, has_categorical=True)]
    got = [a.numpy() for a in psplit.per_feature_best(
        *_port_args(*case), pp, has_categorical=True)]
    gain_r, thr_r, dl_r, lg_r, lh_r, lc_r, bits_r = ref
    gain, thr, dl, lg, lh, lc, bits = got
    live = np.isfinite(gain_r)
    np.testing.assert_array_equal(np.isfinite(gain), live)
    np.testing.assert_array_equal(thr[live], thr_r[live])
    has_missing = case[4] != 0
    np.testing.assert_array_equal(dl[live & has_missing],
                                  dl_r[live & has_missing])
    tot = case[1]
    for f in np.nonzero(live)[0]:
        side = (_cat_side(bits[f], bits_r[f], case[0][f]) if case[5][f]
                else 1)
        want = [v[f] if side == 1 else t - v[f]
                for v, t in zip((lg_r, lh_r, lc_r), tot)]
        np.testing.assert_allclose([lg[f], lh[f], lc[f]], want, rtol=1e-5,
                                   atol=1e-3)
    np.testing.assert_allclose(gain[live], gain_r[live], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", [(-np.inf, np.inf), (-0.05, 0.08)])
def test_per_feature_best_with_tree_options_equals_jax(seed, bounds):
    """Monotone constraints (clamped outputs, the direction veto on the
    numerical features, the clamp alone on the categorical ones) and
    extra_trees' one random candidate per feature, in both scans: the
    same gains and thresholds as the JAX package's."""
    case = _case(seed)
    nb, cat = case[2], case[5]
    rng = np.random.RandomState(seed + 50)
    rand = (rng.randint(0, 1 << 30, len(nb)) % np.maximum(nb - 1, 1)
            ).astype(np.int32)
    mono = np.where(cat, 0, rng.randint(-1, 2, len(nb))).astype(np.int32)
    lo, hi = (np.float32(v) for v in bounds)
    jp, pp = jsplit.SplitParams(max_cat_to_onehot=8), \
        psplit.SplitParams(max_cat_to_onehot=8)
    ref = [np.asarray(a) for a in jsplit.per_feature_best(
        *_jax_args(*case), jp, has_categorical=True,
        constraints=(jnp.asarray(mono), jnp.float32(lo), jnp.float32(hi)),
        rand_thresholds=jnp.asarray(rand))]
    got = [a.numpy() for a in psplit.per_feature_best(
        *_port_args(*case), pp, has_categorical=True,
        constraints=(torch.from_numpy(mono).long(), torch.tensor(lo),
                     torch.tensor(hi)),
        rand_thresholds=torch.from_numpy(rand).long())]
    live = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), live)
    assert live.any()
    num = live & ~cat
    np.testing.assert_array_equal(got[1][num], ref[1][num])
    np.testing.assert_allclose(got[0][live], ref[0][live], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("params", PARAMS)
def test_best_split_equals_find_best_split(seed, params):
    """The batched best split (the fused learner's best_of) picks what
    the JAX package's find_best_split picks, for two leaves at once."""
    cases = [_case(seed), _case(seed, hist_seed=seed + 10)]
    jp, pp = jsplit.SplitParams(**params), psplit.SplitParams(**params)
    refs = [jsplit.find_best_split(*_jax_args(*c), jp, has_categorical=True)
            for c in cases]
    hist = torch.stack([torch.from_numpy(c[0]) for c in cases])
    sums = torch.from_numpy(np.stack([c[1] for c in cases]))
    c0 = cases[0]
    _, _, _, _, _, nb, db, mt, cat, fm = _port_args(*c0)
    bs = psplit.best_split(hist, sums[:, 0], sums[:, 1], sums[:, 2],
                           torch.full((2,), 0.1), 0, nb, db, mt, cat, fm, pp,
                           True, 0)
    for i, r in enumerate(refs):
        ok = bool(np.isfinite(np.asarray(r.gain)))
        assert np.isfinite(bs.gain[i].item()) == ok
        if not ok:
            continue
        f = int(r.feature)
        assert int(bs.feature[i]) == f
        assert int(bs.threshold[i]) == int(r.threshold)
        if c0[4][f] != 0:
            assert bool(bs.default_left[i]) == bool(r.default_left)
        assert bool(bs.is_categorical[i]) == bool(r.is_categorical)
        side = (_cat_side(bs.cat_bitset[i].numpy(), r.cat_bitset,
                          cases[i][0][f]) if r.is_categorical else 1)
        lsum = ((r.left_sum_g, r.left_sum_h, r.left_count) if side == 1 else
                (r.right_sum_g, r.right_sum_h, r.right_count))
        outs = ((r.left_output, r.right_output) if side == 1 else
                (r.right_output, r.left_output))
        for got, want in ((bs.gain[i], r.gain), (bs.left_g[i], lsum[0]),
                          (bs.left_h[i], lsum[1]), (bs.left_c[i], lsum[2]),
                          (bs.left_output[i], outs[0]),
                          (bs.right_output[i], outs[1])):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       atol=1e-4)


def test_max_depth_guard():
    case = _case(7)
    pp = psplit.SplitParams()
    args = _port_args(*case)
    hist, pg, ph, pc, po = args[:5]
    free = psplit.best_split(hist, pg, ph, pc, po, 3, *args[5:], pp, True, 0)
    capped = psplit.best_split(hist, pg, ph, pc, po, 3, *args[5:], pp, True,
                               3)
    assert np.isfinite(free.gain.item()) and free.gain.item() > 0
    assert capped.gain.item() == psplit.K_MIN_SCORE


@pytest.mark.parametrize("f, thr", [(0, 3), (2, 5), (3, 1), (1, 2)])
def test_gather_threshold_split_equals_jax(f, thr):
    hist, tot, nb, db, mt, cat, _ = _case(8)
    p = dict(lambda_l2=1.0)
    r = jsplit.gather_threshold_split(
        jnp.asarray(hist[f]), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.float32(0.0), f, jnp.int32(thr),
        jnp.int32(nb[f]), jnp.int32(db[f]), jnp.int32(mt[f]),
        jnp.asarray(cat[f]), jsplit.SplitParams(**p))
    g = psplit.gather_threshold_split(
        torch.from_numpy(hist[f]), torch.tensor(tot[0]),
        torch.tensor(tot[1]), torch.tensor(tot[2]), 0.0, f, thr,
        int(nb[f]), int(db[f]), int(mt[f]), bool(cat[f]),
        psplit.SplitParams(**p))
    assert bool(g.default_left) == bool(r.default_left)
    assert bool(g.is_categorical) == bool(r.is_categorical)
    np.testing.assert_array_equal(g.cat_bitset.numpy().astype(np.uint32),
                                  np.asarray(r.cat_bitset))
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count", "left_output",
                 "right_output"):
        np.testing.assert_allclose(float(getattr(g, name)),
                                   float(getattr(r, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("missing, dl, is_cat", [
    (0, False, False), (1, True, False), (1, False, False), (2, True, False),
    (2, False, False), (0, False, True)])
def test_decision_go_left_equals_jax(missing, dl, is_cat):
    rng = np.random.RandomState(9)
    bins = rng.randint(0, 40, 500).astype(np.uint8)
    bits = rng.randint(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    args = dict(threshold=17, default_left=dl, default_bin=5,
                missing_type=missing, num_bin=40, is_categorical=is_cat)
    ref = np.asarray(jpart.decision_go_left(
        jnp.asarray(bins), jnp.int32(17), jnp.asarray(dl), jnp.int32(5),
        jnp.int32(missing), jnp.int32(40), jnp.asarray(is_cat),
        jnp.asarray(bits)))
    got = ppart.decision_go_left(torch.from_numpy(bins), cat_bitset=
                                 torch.from_numpy(bits.astype(np.int64)),
                                 **args).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("begin, count", [(0, 1000), (137, 400), (990, 10)])
def test_split_partition_equals_jax(begin, count):
    """The port's stable partition gives JAX's split_partition permutation
    (its stable sort over the padded slice)."""
    rng = np.random.RandomState(10)
    N = 1000
    x = rng.randint(0, 30, (N, 3)).astype(np.uint8)
    perm = rng.permutation(N).astype(np.int32)
    new_j, lc_j = jpart.split_partition(
        jnp.asarray(x), jnp.asarray(perm), jnp.int32(begin), jnp.int32(count),
        jnp.int32(1), jnp.int32(12), jnp.asarray(False), jnp.int32(0),
        jnp.int32(0), jnp.int32(30), jnp.asarray(False),
        jnp.zeros(8, jnp.uint32), padded_size=1024)
    p = torch.from_numpy(perm.copy())
    gl = ppart.decision_go_left(torch.from_numpy(x[perm[begin:begin + count],
                                                   1]), 12, False, 0, 0, 30,
                                False, torch.zeros(8, dtype=torch.int64))
    lc = ppart.split_partition(p, begin, count, gl)
    assert int(lc) == int(lc_j)
    np.testing.assert_array_equal(p.numpy(), np.asarray(new_j))
