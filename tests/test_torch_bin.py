"""Kernel B's plain version (``ops/bin_cuda``) held to the port's mapper
and to the JAX package's binned matrix on the same numpy inputs.

B replaces the JAX package's host C++ binner (``lg_bin_matrix``,
``lambdagap_tpu/native/binner.cpp:172``); on the CPU its wrapper takes
the plain version, so these tests hold the arithmetic the card's kernel
is compared with (``tests/test_torch_kernels.py``, ``chip_smoke.py``
T22). Binning is exact: every comparison is ``array_equal``.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data.dataset import BinnedDataset as JaxDataset
import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data.binning import bounds_table
from lambdagap_tpu_torch.data.dataset import BinnedDataset
from lambdagap_tpu_torch.ops import bin_cuda


def _matrix(n=2000, seed=0):
    """Normal, NaN-laced, +-inf-laced, zero-heavy, a categorical, heavy
    ties, and a normal column whose bounds :func:`_on_bounds` probes."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 7))
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.randn(n)
    X[rng.rand(n) < 0.2, 1] = np.nan
    X[:, 2] = rng.randn(n) * 3
    X[rng.rand(n) < 0.05, 2] = np.inf
    X[rng.rand(n) < 0.05, 2] = -np.inf
    X[:, 3] = np.where(rng.rand(n) < 0.6, 0.0, rng.randn(n))
    X[:, 4] = rng.randint(0, 12, n)
    X[:, 5] = np.round(rng.randn(n), 1)
    X[:, 6] = rng.randn(n)
    return X


def _on_bounds(ds, X, col=6):
    """Column ``col`` of new rows set to the feature's own bounds (and
    their float neighbours): the lower_bound edge cases."""
    b = ds.mappers[col].upper_bounds()
    b = b[np.isfinite(b)]
    vals = np.concatenate([b, np.nextafter(b, -np.inf),
                           np.nextafter(b, np.inf), [0.0, -0.0, np.nan]])
    Xb = np.repeat(X[:1], len(vals), axis=0)
    Xb[:, col] = vals
    return Xb


def _mapper_bins(ds, X):
    return np.stack([ds.mappers[j].values_to_bins(X[:, j]).astype(
        ds.binned.dtype) for j in ds.used_features], axis=1)


@pytest.mark.parametrize("extra", [{}, {"zero_as_missing": True},
                                   {"use_missing": False}],
                         ids=["nan", "zero_as_missing", "no_missing"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_binned_matrix_equals_mapper_and_jax(extra, dtype):
    X = _matrix().astype(dtype)
    params = {"max_bin": 63, "verbose": -1, **extra}
    pds = BinnedDataset.from_matrix(
        X, Config.from_params({**params, "device_type": "cpu"}),
        categorical_features=[4])
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params(params),
                                 categorical_features=[4])
    np.testing.assert_array_equal(pds.binned, jds.binned)
    np.testing.assert_array_equal(pds.binned, _mapper_bins(pds, X))
    # rows on the bounds, binned through the training mappers (a
    # validation set) on both sides
    Xb = _on_bounds(pds, X.astype(np.float64)).astype(dtype)
    pv = BinnedDataset.from_matrix(
        Xb, Config.from_params({**params, "device_type": "cpu"}),
        reference=pds)
    jv = JaxDataset.from_matrix(Xb, JaxConfig.from_params(params),
                                reference=jds)
    np.testing.assert_array_equal(pv.binned, jv.binned)
    np.testing.assert_array_equal(pv.binned, _mapper_bins(pds, Xb))


def test_u16_bins_at_max_bin_511():
    rng = np.random.RandomState(3)
    X = rng.randn(6000, 3)
    X[rng.rand(6000) < 0.1, 0] = np.nan
    params = {"max_bin": 511, "min_data_in_bin": 1, "verbose": -1}
    pds = BinnedDataset.from_matrix(
        X, Config.from_params({**params, "device_type": "cpu"}))
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params(params))
    assert pds.binned.dtype == np.uint16 and max(pds.feature_num_bins) > 256
    np.testing.assert_array_equal(pds.binned, jds.binned)
    np.testing.assert_array_equal(pds.binned, _mapper_bins(pds, X))


def test_bin_rows_leaves_categorical_columns_to_the_mapper():
    """The bounds table skips categorical features: bin_rows writes only
    the numerical columns of its output, and the dataset fills the
    categorical one from the mapper."""
    X = _matrix(n=500)
    ds = BinnedDataset.from_matrix(
        X, Config.from_params({"verbose": -1, "device_type": "cpu"}),
        categorical_features=[4])
    col, dst, nan_bin, bounds, off = bounds_table(ds.mappers,
                                                  ds.used_features)
    k_cat = ds.used_features.index(4)
    assert 4 not in col.tolist() and k_cat not in dst.tolist()
    table = ds.bin_table()
    out = torch.full((500, len(ds.used_features)), 250, dtype=torch.uint8)
    bin_cuda.bin_rows(torch.from_numpy(X), table, out)
    got = out.numpy()
    assert (got[:, k_cat] == 250).all()
    keep = [k for k in range(len(ds.used_features)) if k != k_cat]
    np.testing.assert_array_equal(got[:, keep], ds.binned[:, keep])
    assert len(off) == len(col) + 1 and off[-1] == len(bounds)
    assert all(nan_bin[i] == -1 or nan_bin[i] == ds.mappers[j].num_bin - 1
               for i, j in enumerate(col))


def test_bin_matrix_blocks_and_other_dtypes(monkeypatch):
    """A host matrix goes through in blocks of BLOCK_VALUES values; an
    integer matrix converts to float64 block by block."""
    X = _matrix(n=1000)
    cfg = Config.from_params({"verbose": -1, "device_type": "cpu"})
    whole = BinnedDataset.from_matrix(X, cfg, categorical_features=[4])
    monkeypatch.setattr(bin_cuda, "BLOCK_VALUES", 7 * 64)
    blocked = BinnedDataset.from_matrix(X, cfg, categorical_features=[4])
    np.testing.assert_array_equal(whole.binned, blocked.binned)
    Xi = np.round(X[:, [0, 2, 5]] * 10)
    Xi[~np.isfinite(Xi)] = 0
    Xi = Xi.astype(np.int32)
    di = BinnedDataset.from_matrix(Xi, cfg)
    np.testing.assert_array_equal(di.binned,
                                  _mapper_bins(di, Xi.astype(np.float64)))


def test_bin_rows_checks_its_inputs():
    X = _matrix(n=50)
    ds = BinnedDataset.from_matrix(
        X, Config.from_params({"verbose": -1, "device_type": "cpu"}))
    table = ds.bin_table()
    with pytest.raises(TypeError, match="f32/f64"):
        bin_cuda.bin_rows(torch.from_numpy(X).int(), table)
    with pytest.raises(ValueError, match="contiguous"):
        bin_cuda.bin_rows(torch.from_numpy(X).t().contiguous().t(), table)
    with pytest.raises(ValueError, match="reads column"):
        bin_cuda.bin_rows(torch.from_numpy(X[:, :3].copy()), table)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        bin_cuda.bin_rows(torch.from_numpy(X).to("meta"), table)


F32 = np.finfo(np.float32)


def _searched(table, X, tables):
    """Per numerical feature, the bins of ``X`` by a search over
    ``tables(f)`` (sorted bounds: torch.searchsorted, side left; or B's
    tree as ``("tree", tree, depth)``: B's descent), with the plain
    version's NaN and clip rules; ``[n, Fn]``."""
    out = np.zeros((X.shape[0], table.num_features), np.int64)
    for f in range(table.num_features):
        v = X[:, table.col[f]]
        nan = np.isnan(v)
        v = np.where(nan, v.dtype.type(0), v)
        t = tables(f)
        if isinstance(t, tuple):
            how, tree, depth = t
            k = np.ones(len(v), np.int64)
            levels = depth
            if how == "top" and depth >= 3:
                # the kernel's first step: the count of the top three
                # levels' seven nodes below v is the level-3 node 8 + c
                k = 8 + (tree[1:8][None, :] < v[:, None]).sum(axis=1)
                levels = depth - 3
            for _ in range(levels):
                k = 2 * k + (tree[k] < v)
            idx = k - (1 << depth)
        else:
            idx = torch.searchsorted(torch.from_numpy(t),
                                     torch.from_numpy(v)).numpy()
        idx = np.minimum(idx, table.last[f])
        if table.nan_bin[f] >= 0:
            idx = np.where(nan, table.nan_bin[f], idx)
        out[:, f] = idx
    return out


def _float32_table_checks(table, X32, plain, jax_binned):
    """The float32 table's search (torch.searchsorted over RD32 of the
    bounds, and B's descent over the float32 tree), the float64 tree's
    descent on the rows widened, the plain version and the JAX package's
    bins: all equal on the numerical columns."""
    dst = table.dst
    np.testing.assert_array_equal(plain[:, dst], jax_binned[:, dst])
    want = plain[:, dst].astype(np.int64)
    b32 = bin_cuda.round_down_f32(table.bounds)
    lo, hi = table.off[:-1], table.off[1:]
    np.testing.assert_array_equal(
        _searched(table, X32, lambda f: b32[lo[f]:hi[f]]), want)
    for how in ("tree", "top"):
        tree = lambda t: lambda f: (how, t[table.toff[f]:table.toff[f + 1]],
                                    int(table.depth[f]))
        np.testing.assert_array_equal(
            _searched(table, X32, tree(table.tree32)), want)
        np.testing.assert_array_equal(
            _searched(table, X32.astype(np.float64), tree(table.tree64)),
            want)


@pytest.mark.parametrize("extra", [{}, {"zero_as_missing": True},
                                   {"use_missing": False}],
                         ids=["nan", "zero_as_missing", "no_missing"])
@pytest.mark.parametrize("max_bin", [63, 511])
def test_float32_table_equals_float64_search_and_jax(max_bin, extra):
    """B's float32 table (each bound rounded down to float32) counts the
    same bounds as the float64 search for every float32 value: each
    bound's RD32 and its neighbours, signed zeros, subnormals, +-FLT_MAX,
    infinities and NaN, under each missing type; B's trees (float32 and
    float64) give the same bins by B's descent."""
    X = _matrix(n=3000).astype(np.float32)
    X[:, 6] = np.random.RandomState(5).randn(3000).astype(np.float32) * 1e-42
    params = {"max_bin": max_bin, "min_data_in_bin": 1, "verbose": -1,
              **extra}
    pds = BinnedDataset.from_matrix(
        X, Config.from_params({**params, "device_type": "cpu"}),
        categorical_features=[4])
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params(params),
                                 categorical_features=[4])
    table = pds.bin_table()
    assert table.out_dtype == (np.uint8 if max_bin == 63 else np.uint16)
    Xa = bin_cuda.edge_rows(table, X.shape[1])
    pv = BinnedDataset.from_matrix(
        Xa, Config.from_params({**params, "device_type": "cpu"}),
        reference=pds)
    jv = JaxDataset.from_matrix(Xa, JaxConfig.from_params(params),
                                reference=jds)
    _float32_table_checks(table, Xa, pv.binned, jv.binned)


def test_float32_table_with_bounds_past_flt_max():
    """Bounds from a float64 sample beyond float32's range (RD32 of a bound
    past FLT_MAX is FLT_MAX, of one below -FLT_MAX -inf), searched by
    float32 rows binned through ``reference=``: the float32 table, the
    float64 search and the JAX package agree."""
    rng = np.random.RandomState(11)
    X = rng.randn(4000, 3)
    X[:, 0] = rng.choice([-1e300, -1e39, -3.4e38, -1.0, 0.0, 1.0, 3.4e38,
                          3.41e38, 1e39, 1e300], 4000)
    X[:, 1] = rng.choice([-np.inf, -1e200, 2.0, 1e200, np.inf, np.nan],
                         4000)
    params = {"max_bin": 63, "min_data_in_bin": 1, "verbose": -1}
    pds = BinnedDataset.from_matrix(
        X, Config.from_params({**params, "device_type": "cpu"}))
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params(params))
    table = pds.bin_table()
    finite = table.bounds[np.isfinite(table.bounds)]
    assert finite.max() > F32.max and finite.min() < -F32.max
    Xa = bin_cuda.edge_rows(table, X.shape[1])
    pv = BinnedDataset.from_matrix(
        Xa, Config.from_params({**params, "device_type": "cpu"}),
        reference=pds)
    jv = JaxDataset.from_matrix(Xa, JaxConfig.from_params(params),
                                reference=jds)
    _float32_table_checks(table, Xa, pv.binned, jv.binned)


def test_bin_plan_stages_mslr_width_float32_in_one_tile():
    """At MSLR-WEB30K's 136 features and 255 bins the float32 trees fit one
    block beside its row buffers (one pass over the rows); the float64
    trees take two tiles; a 40,000-bin feature is a tile searched in device
    memory. Checked against the card's opt-in 232,448 shared bytes."""
    rng = np.random.RandomState(2)
    X = rng.randn(20000, 136).astype(np.float32)
    ds = BinnedDataset.from_matrix(X, Config.from_params(
        {"max_bin": 255, "verbose": -1, "device_type": "cpu"}))
    table = ds.bin_table()
    assert (table.depth == 8).all()
    cap = 232448
    p32 = bin_cuda._feature_tiles(np.diff(table.toff), 64, 4, 1, cap)
    assert p32[1] == [1] and p32[0] == [0, 136] and p32[2] <= cap
    assert bin_cuda._feature_tiles(np.diff(table.toff), 128, 4, 1,
                                   cap)[1] == [1, 1]
    assert len(bin_cuda._feature_tiles(np.diff(table.toff), 64, 8, 1,
                                       cap)[1]) == 2
    sizes = np.array([256, 1 << 16, 256])
    tiles, staged, _ = bin_cuda._feature_tiles(sizes, 128, 4, 2, cap)
    assert tiles == [0, 1, 2, 3] and staged == [1, 0, 1]
    # the plan keeps the one tile (a stand-in for the occupancy query: 228
    # KB and 2,048 threads an SM)
    occ = lambda threads, smem: min(233472 // (smem + 1024), 2048 // threads)
    plan = table.plan(torch.device("cpu"), 4, cap, occ)
    assert plan["n_tiles"] == 1 and plan["smem"] <= cap
    assert plan["threads"] % (32 * plan["groups"]) == 0
    assert plan["smem"] == bin_cuda._tile_bytes(
        136, int(table.toff[-1]), True, plan["rows"], 4, 1, plan["groups"])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_categorical_past_256_bins_fails_in_both_packages(fused):
    """A categorical feature binned past 256 bins: the JAX package's split
    scan cannot hold its bitset (``_bins_to_bitset``,
    ``lambdagap_tpu/ops/split.py:402-408``) and raises ``TypeError`` in
    both learners; the port refuses by name with ``NotImplementedError``
    (ROADMAP.md, Queue 3)."""
    rng = np.random.RandomState(0)
    X = np.column_stack([rng.randint(0, 400, 4000), rng.randn(4000)])
    y = (X[:, 0] % 2 + X[:, 1] > 0.5).astype(float)
    params = {"objective": "binary", "max_bin": 511, "verbose": -1,
              "min_data_in_bin": 1, "max_cat_to_onehot": 4,
              "num_leaves": 7, "tpu_fused_learner": fused}
    with pytest.raises(TypeError, match="reshape"):
        lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[0]),
                  1)
    with pytest.raises(NotImplementedError, match="256 bins"):
        lgt.train({**params, "device_type": "cpu"},
                  lgt.Dataset(X, label=y, categorical_feature=[0]), 1)
