"""EFB on the CPU, held to the JAX package: the bundled matrix, its decode
metadata and the un-bundling map ``array_equal`` to
``lambdagap_tpu/data/bundling.py``'s; ``unbundle_hist`` against JAX's on
the same histograms (exact gathers; the residual default bins within rtol
1e-6, since the two sum the other bins in different orders); the partition's
rank decode against the JAX learner's formula; and bundled training runs
against the JAX fused learner at the training-row bar (rtol 1e-4 / atol
1e-5)."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.data import bundling as jb
from lambdagap_tpu.ops import histogram as jh
from lambdagap_tpu_torch.data import bundling as pb
from lambdagap_tpu_torch.data.dataset import BinnedDataset
from lambdagap_tpu_torch.ops import histogram as ph
from lambdagap_tpu_torch.ops.partition import decode_bundled

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}


def _table(seed=17, n=2000, groups=2, width=5, dense=3, levels=None):
    """``dense`` normal features, then ``groups`` groups of ``width``
    mutually exclusive sparse columns (one or none non-zero per row)."""
    rng = np.random.RandomState(seed)
    cols = [rng.randn(n, dense)]
    for _ in range(groups):
        which = rng.randint(0, width + 1, n)        # width: none of them
        g = np.zeros((n, width))
        on = which < width
        vals = (rng.randint(1, levels + 1, on.sum()) if levels
                else rng.rand(on.sum()) + 0.5)
        g[np.nonzero(on)[0], which[on]] = vals
        cols.append(g)
    X = np.concatenate(cols, axis=1)
    y = X @ rng.randn(X.shape[1]) * 0.5 + 0.2 * rng.randn(n)
    return X, y


def _bundles(X, **cfg):
    ds = BinnedDataset.from_matrix(
        X, lgt.Config.from_params({"verbose": -1, **cfg}))
    nb = np.asarray(ds.feature_num_bins, np.int32)
    db = ds.feature_arrays()["default_bins"]
    return ds, nb, db


@pytest.mark.parametrize("kw", [{}, {"levels": 8}, {"groups": 3, "width": 6,
                                                    "levels": 30},
                                {"max_bin": 400}])
def test_bundled_matrix_and_map_equal_jax(kw):
    kw = dict(kw)
    cfg = {"max_bin": kw.pop("max_bin")} if "max_bin" in kw else {}
    X, _ = _table(**kw)
    ds, nb, db = _bundles(X, **cfg)
    got = pb.build_bundle(ds.binned, nb, db, 0.0)
    ref = jb.build_bundle(ds.binned, nb, db, 0.0)
    assert got is not None and ref is not None
    assert got.members == ref.members
    assert any(len(m) > 1 for m in got.members)
    assert got.cols.dtype == ref.cols.dtype
    for k in ("cols", "col_of", "off_of", "single"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.num_bins == ref.num_bins and got.num_cols < X.shape[1]
    B = max(int(pow(2, np.ceil(np.log2(nb.max())))), 8)
    Bb = int(pow(2, np.ceil(np.log2(max(got.num_bins)))))
    for a, b in zip(pb.unbundle_map(got, nb, db, B, Bb),
                    jb.unbundle_map(ref, nb, db, B, Bb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dataset_builds_the_bundle_once_and_only_when_enabled():
    X, _ = _table()
    ds, _, _ = _bundles(X)
    off = ds.ensure_bundle(lgt.Config.from_params({"enable_bundle": False}))
    assert off is None and ds.ensure_bundle(lgt.Config()) is None
    ds2, _, _ = _bundles(X)
    bun = ds2.ensure_bundle(lgt.Config())
    assert bun is not None and ds2.ensure_bundle(lgt.Config()) is bun
    dense, _, _ = _bundles(np.random.RandomState(0).randn(500, 6))
    assert dense.ensure_bundle(lgt.Config()) is None


@pytest.mark.parametrize("lead", [(), (2,)])
def test_unbundle_hist_equals_jax(lead):
    X, _ = _table(levels=8)
    ds, nb, db = _bundles(X)
    bun = pb.build_bundle(ds.binned, nb, db, 0.0)
    B = 256
    Bb = int(pow(2, np.ceil(np.log2(max(bun.num_bins)))))
    src, kind = pb.unbundle_map(bun, nb, db, B, Bb)
    rng = np.random.RandomState(2)
    C = bun.num_cols
    hb = rng.randn(*lead, C, Bb, 3).astype(np.float32)
    tot = rng.randn(*lead, 3).astype(np.float32) * 10
    got = ph.unbundle_hist(torch.from_numpy(hb),
                           torch.from_numpy(src.astype(np.int64)),
                           torch.from_numpy(kind),
                           torch.from_numpy(tot)).numpy()
    hbs = hb.reshape((-1, C, Bb, 3))
    tots = tot.reshape((-1, 3))
    for i in range(hbs.shape[0]):
        ref = np.asarray(jh.unbundle_hist(
            jnp.asarray(hbs[i]), jnp.asarray(src), jnp.asarray(kind),
            tots[i, 0], tots[i, 1], tots[i, 2]))
        g = got.reshape((-1,) + ref.shape)[i]
        copy = kind != jb.KIND_DEFAULT
        np.testing.assert_array_equal(g[copy], ref[copy])
        np.testing.assert_allclose(g[~copy], ref[~copy], rtol=1e-6,
                                   atol=1e-5)


def test_partition_decode_recovers_each_feature_bin():
    """Every member's bins decode from its bundle column back to the
    unbundled matrix (conflict-free data), as fused_learner.py:1196-1202
    decodes them."""
    X, _ = _table(levels=8, groups=3)
    ds, nb, db = _bundles(X)
    bun = pb.build_bundle(ds.binned, nb, db, 0.0)
    for f in range(ds.num_features):
        col = torch.from_numpy(bun.cols[:, bun.col_of[f]].astype(np.int64))
        if bun.single[f]:
            np.testing.assert_array_equal(col.numpy(), ds.binned[:, f])
            continue
        got = decode_bundled(col, int(bun.off_of[f]), int(db[f]),
                             int(nb[f])).numpy()
        np.testing.assert_array_equal(got, ds.binned[:, f])


@pytest.mark.parametrize("extra", [
    {},
    {"objective": "binary"},
    {"use_quantized_grad": True, "num_grad_quant_bins": 16},
    {"bagging_fraction": 0.7, "bagging_freq": 1},
])
def test_bundled_training_matches_jax(extra):
    """Training over bundled columns: the same bundles on both sides and
    the JAX fused learner's predictions on the training rows."""
    X, y = _table(levels=8)
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              **extra}
    if params["objective"] == "binary":
        y = (y > np.median(y)).astype(np.float64)
    dj = lgb.Dataset(X, label=y)
    bj = lgb.train({**params, **JAX_F32}, dj, 8)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 8)
    lr = bt._booster.learner
    assert lr.bundle is not None
    assert lr.bundle.members == dj.construct().bundle.members
    assert lr.x_rows.shape[1] < lr.num_features
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]
    # the same model as training with bundling off
    bo = lgt.train({**params, **CPU, "enable_bundle": False},
                   lgt.Dataset(X, label=y), 8)
    np.testing.assert_allclose(bt.predict(X), bo.predict(X), rtol=1e-4,
                               atol=1e-5)
