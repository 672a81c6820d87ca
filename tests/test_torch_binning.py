"""Binning, the binned matrix and the EFB grouping decision of the port
held to the JAX package on the same numpy inputs: bin boundaries, missing
types, default bins, categorical maps and binned matrices are equal
(``array_equal``), and so are the EFB groups — both sides run the same
numpy arithmetic, so nothing here needs a tolerance.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data import bundling as jax_bundling
from lambdagap_tpu.data.binning import BinMapper as JaxBinMapper
from lambdagap_tpu.data.dataset import BinnedDataset as JaxDataset
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.convert import dataset_fields, dataset_from_numpy
from lambdagap_tpu_torch.data import bundling
from lambdagap_tpu_torch.data.binning import BinMapper
from lambdagap_tpu_torch.data.dataset import BinnedDataset

MAPPER_KEYS = ("bin_type", "missing_type", "num_bin", "default_bin",
               "most_freq_bin", "min_val", "max_val", "is_trivial",
               "bin_2_categorical", "categorical_2_bin")


def _matrix(seed=0, n=3000):
    """Columns: plain normal, NaN-laced, zero-heavy, small-int categorical,
    wide-int categorical with NaN, a constant, heavy ties, exponential."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 8))
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.randn(n)
    X[rng.rand(n) < 0.15, 1] = np.nan
    X[:, 2] = np.where(rng.rand(n) < 0.7, 0.0, rng.randn(n))
    X[:, 3] = rng.randint(0, 9, n)
    X[:, 4] = rng.randint(0, 400, n).astype(float)
    X[rng.rand(n) < 0.05, 4] = np.nan
    X[:, 5] = 3.0
    X[:, 6] = np.round(rng.randn(n), 1)
    X[:, 7] = rng.exponential(size=n) * 1e3
    return X


def _same_mapper(a, b):
    for k in MAPPER_KEYS:
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(np.asarray(a.bin_upper_bound),
                                  np.asarray(b.bin_upper_bound))
    for i in range(a.num_bin + 1):
        assert a.bin_to_value(i) == b.bin_to_value(i)


@pytest.mark.parametrize("max_bin", [15, 63, 255, 300])
@pytest.mark.parametrize("extra", [{}, {"zero_as_missing": True},
                                   {"use_missing": False},
                                   {"bin_construct_sample_cnt": 1000,
                                    "min_data_in_bin": 7}])
def test_dataset_equals_jax(max_bin, extra):
    X = _matrix()
    y = (X[:, 0] > 0).astype(float)
    params = {"max_bin": max_bin, "verbose": -1, **extra}
    cats = [3, 4]
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params(params), label=y,
                                 categorical_features=cats)
    pcfg = Config.from_params({**params, "device_type": "cpu"})
    pds = BinnedDataset.from_matrix(X, pcfg, label=y,
                                    categorical_features=cats)
    assert pds.used_features == jds.used_features
    assert pds.feature_num_bins == jds.feature_num_bins
    assert pds.bin_offsets == jds.bin_offsets
    for a, b in zip(pds.mappers, jds.mappers):
        _same_mapper(a, b)
    # u16 once any feature has more than 256 bins (max_bin=300, or the
    # 400-category column, whose bins follow the 99% coverage rule)
    assert pds.binned.dtype == jds.binned.dtype
    np.testing.assert_array_equal(pds.binned, jds.binned)
    for k, v in pds.feature_arrays().items():
        np.testing.assert_array_equal(v, jds.feature_arrays()[k])
    # a validation set binned with the training set's mappers
    Xv = _matrix(seed=1, n=700)
    jv = JaxDataset.from_matrix(Xv, JaxConfig.from_params(params),
                                reference=jds)
    pv = BinnedDataset.from_matrix(Xv, pcfg,
                                   reference=pds)
    np.testing.assert_array_equal(pv.binned, jv.binned)


@pytest.mark.parametrize("kind", ["numerical", "categorical"])
def test_find_bin_equals_jax(kind):
    rng = np.random.RandomState(3)
    vals = (rng.randint(-3, 40, 5000).astype(float) if kind == "categorical"
            else np.concatenate([rng.randn(4000), [np.nan] * 50,
                                 [1e-40, -1e-40]]))
    kw = dict(total_sample_cnt=6000, max_bin=63, min_data_in_bin=3,
              bin_type=kind)
    a, b = BinMapper.find_bin(vals, **kw), JaxBinMapper.find_bin(vals, **kw)
    _same_mapper(a, b)
    probe = np.concatenate([vals[:300], [np.nan, 0.0, 1e9, -1e9, 39.0]])
    np.testing.assert_array_equal(a.values_to_bins(probe),
                                  b.values_to_bins(probe))


@pytest.mark.parametrize("sparse", [False, True])
def test_efb_groups_equal_jax(sparse):
    rng = np.random.RandomState(5)
    n, F = 4000, 12
    if sparse:
        # mutually exclusive one-hot-like columns: EFB bundles them
        which = rng.randint(0, F, n)
        X = np.zeros((n, F))
        X[np.arange(n), which] = rng.rand(n) + 0.5
    else:
        X = rng.randn(n, F)
    ds = BinnedDataset.from_matrix(
        X, Config.from_params({"verbose": -1, "device_type": "cpu"}))
    nb = np.asarray(ds.feature_num_bins, np.int32)
    db = ds.feature_arrays()["default_bins"]
    got = bundling.build_bundle(ds.binned, nb, db, 0.0)
    ref = jax_bundling.build_bundle(ds.binned, nb, db, 0.0)
    if sparse:
        assert got is not None and ref is not None
        assert got.members == ref.members
        assert any(len(g) > 1 for g in got.members)
        np.testing.assert_array_equal(got.cols, ref.cols)
        assert got.cols.dtype == ref.cols.dtype
    else:
        # dense data forms no bundle (bundling.py:121-122)
        assert got is None and ref is None
    nz = ds.binned[:1000] != db[None, :]
    assert bundling.find_groups(nz, nb, 0.01) == \
        jax_bundling.find_groups(nz, nb, 0.01)


def test_dataset_round_trips_through_numpy():
    """convert.dataset_from_numpy rebuilds the JAX package's dataset field
    for field: mappers, matrix, labels."""
    X = _matrix(seed=2, n=900)
    y = np.random.RandomState(2).rand(900)
    w = np.random.RandomState(3).rand(900)
    jds = JaxDataset.from_matrix(X, JaxConfig.from_params({"verbose": -1}),
                                 label=y, weight=w, categorical_features=[3])
    pds = dataset_from_numpy(dataset_fields(jds))
    for a, b in zip(pds.mappers, jds.mappers):
        _same_mapper(a, b)
    np.testing.assert_array_equal(pds.binned, jds.binned)
    np.testing.assert_array_equal(pds.metadata.label, jds.metadata.label)
    np.testing.assert_array_equal(pds.metadata.weight, jds.metadata.weight)
    assert pds.used_features == jds.used_features
    assert pds.bin_offsets == jds.bin_offsets
