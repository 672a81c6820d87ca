"""Out-of-core training in the port (``data_residency=stream``), on the CPU.

* ``QuantileSketch`` and the mappers it builds equal the JAX package's
  (``array_equal``: distinct values, counts, boundaries) below the sketch
  budget, at its edge and above it (where it compacts), and after a merge.
* ``ShardedBinnedDataset`` built ``from_matrix``, ``from_sequences`` (two
  readers), into a spill directory (``np.memmap`` shards) and
  ``from_dataset`` holds the JAX package's shards, and a ``Sequence``
  Dataset bins as the JAX package's ``from_sequences`` does.
* Stream training grows the port's own resident model byte for byte up to
  ``end of trees`` across both learners, both layouts, ragged shards,
  bagging, GOSS with compaction on and off and a categorical feature: the
  windows reach K1's accumulate mode as exact integer sums.
* Stream training holds the JAX package's stream training at the
  train-parity bar (predictions on the training rows, rtol 1e-4 / atol
  1e-5).
* Each stream blocker of the fused learner falls back to hbm with the JAX
  warning; ``auto`` with ``stream_hbm_budget_mb`` streams in both
  packages once the estimate passes the budget, and stays resident under
  it.
* The ring (``ShardRing`` / ``WindowPump``) on the CPU hands the windows
  back in order, at most ``depth`` in flight.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import logging

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data import binning as jbin
from lambdagap_tpu.data.dataset import BinnedDataset as JaxBinned
from lambdagap_tpu.data.stream import ShardedBinnedDataset as JaxSharded
from lambdagap_tpu_torch.data import binning as tbin
from lambdagap_tpu_torch.data.dataset import BinnedDataset
from lambdagap_tpu_torch.data.stream import (ShardedBinnedDataset, ShardRing,
                                             WindowPump, stream_windows)

CPU = {"device_type": "cpu"}
BASE = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 10,
        "learning_rate": 0.2, "verbose": -1, "enable_bundle": False,
        "stream_shard_rows": 1024}


def _data(n=3000, d=6, seed=11, cat=False):
    """tests/test_stream.py's data: 3000 rows over 1,024-row shards, a
    ragged 952-row tail, leaves that cross shard boundaries."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    if cat:
        X[:, 0] = rng.randint(0, 9, n)
    y = (X[:, 1] + np.sin(X[:, 2] * 2)
         + ((X[:, 0] % 3) if cat else X[:, 3]) * 0.5 + 0.1 * rng.randn(n))
    return X, y


def _trees(bst) -> str:
    return bst.model_to_string().split("end of trees")[0]


# -- the sketch and the mappers ----------------------------------------------
def _sketch_values(case):
    rng = np.random.RandomState(2)
    if case == "exact":
        v = np.concatenate([rng.randn(3000), [np.nan] * 37, [0.0] * 400])
    elif case == "edge":           # exactly the budget's distinct values
        v = np.concatenate([np.repeat(rng.randn(256), 3), [0.0] * 50])
    elif case == "edge_plus_one":
        v = np.concatenate([np.repeat(rng.randn(257), 3), [np.nan] * 5])
    else:                          # many more distinct values than 256
        v = np.concatenate([rng.randn(9000), rng.randint(0, 40, 3000)])
    rng.shuffle(v)
    return v


@pytest.mark.parametrize("case", ["exact", "edge", "edge_plus_one",
                                  "compacted", "merged"])
def test_quantile_sketch_equals_jax(case):
    """The same pushes (ragged blocks) give the JAX package's distinct
    values, counts, NaN and row totals, and the same mappers (numerical
    and categorical), exactly; ``merged``: two sketches of halves merged,
    compacting, as sharded construction merges them."""
    budget = 1 << 16 if case == "exact" else 256
    vals = _sketch_values("compacted" if case == "merged" else case)
    sketches = []
    for mod in (tbin, jbin):
        if case == "merged":
            a, b = mod.QuantileSketch(budget), mod.QuantileSketch(budget)
            a.push(vals[:5000])
            b.push(vals[5000:])
            sk = a.merge(b)
        else:
            sk = mod.QuantileSketch(budget)
            for lo in range(0, len(vals), 517):
                sk.push(vals[lo:lo + 517])
        sk._merge_pending()
        sketches.append(sk)
    t, j = sketches
    assert np.array_equal(t.distinct, j.distinct)
    assert np.array_equal(t.counts, j.counts)
    assert (t.na_cnt, t.total) == (j.na_cnt, j.total)
    if case in ("compacted", "merged"):
        assert len(t.distinct) <= budget
    for kw in ({"max_bin": 63, "min_data_in_bin": 3},
               {"max_bin": 255, "min_data_in_bin": 1,
                "zero_as_missing": True}):
        mt, mj = t.to_mapper(**kw), j.to_mapper(**kw)
        assert np.array_equal(np.asarray(mt.bin_upper_bound),
                              np.asarray(mj.bin_upper_bound), equal_nan=True)
        assert (mt.num_bin, mt.missing_type, mt.default_bin,
                mt.most_freq_bin) == (mj.num_bin, mj.missing_type,
                                      mj.default_bin, mj.most_freq_bin)
    cat = np.abs(np.round(vals[:2000] * 3))
    ct, cj = tbin.QuantileSketch(budget), jbin.QuantileSketch(budget)
    ct.push(cat)
    cj.push(cat)
    mt = ct.to_mapper(32, 1, bin_type=tbin.BIN_CATEGORICAL)
    mj = cj.to_mapper(32, 1, bin_type=jbin.BIN_CATEGORICAL)
    assert mt.bin_2_categorical == mj.bin_2_categorical
    assert mt.num_bin == mj.num_bin


class _Rows(lgt.Sequence):
    """A row-batch reader over a slice of a matrix."""

    def __init__(self, X, batch_size=333):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return len(self.X)

    def __getitem__(self, sl):
        return self.X[sl]


class _JaxRows(lgb.Sequence):
    def __init__(self, X, batch_size=333):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return len(self.X)

    def __getitem__(self, sl):
        return self.X[sl]


def _assert_same_bins(t, j):
    assert t.used_features == j.used_features
    assert t.feature_num_bins == j.feature_num_bins
    assert [int(v) for v in t.bin_offsets] == [int(v) for v in j.bin_offsets]
    for mt, mj in zip(t.mappers, j.mappers):
        assert np.array_equal(np.asarray(mt.bin_upper_bound),
                              np.asarray(mj.bin_upper_bound), equal_nan=True)
        assert mt.bin_2_categorical == mj.bin_2_categorical


def test_sequence_dataset_bins_as_jax():
    """``Dataset(Sequence)`` and ``Dataset([Sequence, Sequence])`` route to
    ``from_sequences`` (sketch bins over every row, no row sample) and
    give the JAX package's mappers and binned matrix; a validation
    Sequence takes the training bins; a scipy sparse training matrix
    bins through the same streaming path as the JAX package's."""
    X, y = _data(n=2500, cat=True)
    X[::11, 4] = np.nan
    cfg = {**CPU, "max_bin": 63, "verbose": -1}
    for seqs in ([X], [X[:1100], X[1100:]]):
        t = lgt.Dataset([_Rows(a) for a in seqs] if len(seqs) > 1
                        else _Rows(seqs[0]), label=y,
                        categorical_feature=[0], params=cfg).construct()
        j = lgb.Dataset([_JaxRows(a) for a in seqs] if len(seqs) > 1
                        else _JaxRows(seqs[0]), label=y,
                        categorical_feature=[0], params=cfg).construct()
        _assert_same_bins(t, j)
        assert np.array_equal(t.binned, j.binned)
    tr = lgt.Dataset(_Rows(X), label=y, params=cfg)
    va = lgt.Dataset(_Rows(X[:700] * 1.5), label=y[:700], reference=tr,
                     params=cfg).construct()
    assert va.mappers is tr.construct().mappers
    scipy_sparse = pytest.importorskip("scipy.sparse")
    Xs = np.where(np.abs(np.nan_to_num(X)) < 0.5, 0.0, X)
    t = lgt.Dataset(scipy_sparse.csr_matrix(Xs), label=y,
                    params=cfg).construct()
    j = lgb.Dataset(scipy_sparse.csr_matrix(Xs), label=y,
                    params=cfg).construct()
    _assert_same_bins(t, j)
    assert np.array_equal(t.binned, j.binned)


@pytest.mark.parametrize("route", ["from_matrix", "from_sequences",
                                   "spill_dir", "from_dataset"])
def test_sharded_dataset_equals_jax(route, tmp_path):
    """Host shards of 1,024 rows with a ragged tail, built four ways, hold
    the JAX package's shards and bins exactly; ``binned`` materializes the
    dataset-order matrix; the row and column gathers equal numpy's."""
    X, y = _data(n=3500, d=5)
    X[::13, 2] = np.nan
    p = {"max_bin": 63, "stream_sketch_budget": 512}
    tc, jc = lgt.Config.from_params({**p, **CPU}), JaxConfig.from_params(p)
    if route == "from_matrix":
        t = ShardedBinnedDataset.from_matrix(X, tc, shard_rows=1024, label=y)
        j = JaxSharded.from_matrix(X, jc, shard_rows=1024, label=y)
    elif route == "from_sequences":
        t = ShardedBinnedDataset.from_sequences(
            [_Rows(X[:1700]), _Rows(X[1700:])], tc, shard_rows=1024,
            label=y)
        j = JaxSharded.from_sequences(
            [_JaxRows(X[:1700]), _JaxRows(X[1700:])], jc, shard_rows=1024,
            label=y)
    elif route == "spill_dir":
        t = ShardedBinnedDataset.from_matrix(
            X, tc, shard_rows=1024, spill_dir=str(tmp_path / "t"), label=y)
        j = JaxSharded.from_matrix(
            X, jc, shard_rows=1024, spill_dir=str(tmp_path / "j"), label=y)
        assert all(isinstance(s, np.memmap) for s in t.shards)
        assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
            sorted(p.name for p in (tmp_path / "j").iterdir())
    else:
        t = ShardedBinnedDataset.from_dataset(
            BinnedDataset.from_matrix(X, tc, label=y), 1024)
        j = JaxSharded.from_dataset(JaxBinned.from_matrix(X, jc, label=y),
                                    1024)
    _assert_same_bins(t, j)
    assert [s.shape for s in t.shards] == [s.shape for s in j.shards]
    assert [s.shape[0] for s in t.shards] == [1024, 1024, 1024, 428]
    for a, b in zip(t.shards, j.shards):
        assert np.array_equal(a, b)
    assert np.array_equal(t.binned, j.binned)
    assert np.array_equal(t.metadata.label, j.metadata.label)
    idx = np.random.RandomState(0).permutation(3500)[:1500]
    assert np.array_equal(t.gather_rows(idx), t.binned[idx])
    assert np.array_equal(t.gather_col(3, idx), t.binned[idx, 3])
    assert np.array_equal(t.row_block(1000, 2100), t.binned[1000:2100])


# -- stream == resident ------------------------------------------------------
STREAM_CASES = {
    "fused_gather": {},
    "fused_sorted": {"tree_layout": "sorted"},
    "serial_gather": {"tpu_fused_learner": "0"},
    "serial_sorted": {"tpu_fused_learner": "0", "tree_layout": "sorted"},
    "ragged_512": {"stream_shard_rows": 1500, "stream_prefetch_depth": 1},
    "bagging_cat": {"bagging_fraction": 0.6, "bagging_freq": 1},
    "bagging_cat_serial_sorted": {"bagging_fraction": 0.6,
                                  "bagging_freq": 1, "tpu_fused_learner": "0",
                                  "tree_layout": "sorted"},
    "goss_compact": {"data_sample_strategy": "goss", "top_rate": 0.2,
                     "other_rate": 0.1, "learning_rate": 0.5},
    "goss_no_compact": {"data_sample_strategy": "goss", "top_rate": 0.2,
                        "other_rate": 0.1, "learning_rate": 0.5,
                        "stream_goss_compact": False},
    "goss_compact_sorted_depth4": {
        "data_sample_strategy": "goss", "top_rate": 0.2, "other_rate": 0.1,
        "learning_rate": 0.5, "tree_layout": "sorted",
        "stream_prefetch_depth": 4},
    "goss_serial": {"data_sample_strategy": "goss", "top_rate": 0.2,
                    "other_rate": 0.1, "learning_rate": 0.5,
                    "tpu_fused_learner": "0"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_training_equals_resident(case):
    """data_residency=stream grows the resident model byte for byte up to
    ``end of trees``; the learner holds no device matrix, and its host
    reads are the split count more (the go-left flags), one more a tree
    under compaction (the mask)."""
    extra = STREAM_CASES[case]
    cat = "cat" in case
    X, y = _data(seed=9 if cat else 5, cat=cat)
    if extra.get("objective") == "multiclass":
        y = np.digitize(y, np.quantile(y, [0.33, 0.66]))
    rounds = 5
    texts, learners = {}, {}
    for mode in ("hbm", "stream"):
        bst = lgt.train({**BASE, **CPU, **extra, "data_residency": mode},
                        lgt.Dataset(X, label=y,
                                    categorical_feature=[0] if cat else
                                    "auto"), rounds)
        texts[mode] = _trees(bst)
        learners[mode] = bst._booster.learner
    assert texts["stream"] == texts["hbm"]
    lr = learners["stream"]
    assert lr.residency == "stream" and lr.x_rows is None
    assert learners["hbm"].residency == "hbm"
    lay = lr.row_layout
    assert lay.ring.windows > 0
    assert set(lay.clock.snapshot()) == {"h2d_prefetch", "chunk_wait",
                                         "host_read", "host_mirror"}


def test_stream_from_sharded_dataset_and_spill(tmp_path):
    """``lgt.Dataset(ShardedBinnedDataset)`` passes through (taking the
    label it lacks) and ``auto`` streams it, over ``np.memmap`` shards
    under ``stream_spill_dir`` too; the shards are read, never copied to
    the device."""
    X, y = _data(n=2200)
    cfg = lgt.Config.from_params({**BASE, **CPU})
    sds = ShardedBinnedDataset.from_matrix(X, cfg, shard_rows=1024)
    a = lgt.train({**BASE, **CPU}, lgt.Dataset(sds, label=y), 3)
    assert a._booster.learner.residency == "stream"
    assert a._booster.learner.sdata is sds
    b = lgt.train({**BASE, **CPU, "data_residency": "stream",
                   "stream_spill_dir": str(tmp_path)},
                  lgt.Dataset(X, label=y), 3)
    assert isinstance(b._booster.learner.sdata.shards[0], np.memmap)
    assert len(list(tmp_path.iterdir())) == 3
    assert _trees(a) == _trees(b)


@pytest.mark.parametrize("fused", [True, False])
def test_stream_training_matches_jax_stream(fused):
    """The port's stream training against the JAX package's stream
    training (one-hot f32 histograms): predictions on the training rows
    within the train-parity bar."""
    X, y = _data(seed=7)
    p = {**BASE, "data_residency": "stream",
         "tpu_fused_learner": "1" if fused else "0"}
    bt = lgt.train({**p, **CPU}, lgt.Dataset(X, label=y), 4)
    bj = lgb.train({**p, "tpu_hist_impl": "onehot",
                    "tpu_hist_precision": "f32"}, lgb.Dataset(X, label=y), 4)
    assert bt._booster.learner.residency == "stream"
    assert bj._booster.learner.residency == "stream"
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)


BLOCKERS = {"use_quantized_grad": {"use_quantized_grad": True},
            "forcedsplits_filename": None,
            "interaction_constraints": {"interaction_constraints":
                                        [[0, 1], [2, 3, 4, 5]]},
            "extra_trees": {"extra_trees": True},
            "feature_fraction_bynode": {"feature_fraction_bynode": 0.5},
            "monotone_constraints": {"monotone_constraints":
                                     [1, 0, 0, 0, 0, 0]},
            "feature_contri": {"feature_contri": [1.0, 0.5, 1, 1, 1, 1]}}


@pytest.mark.parametrize("knob", list(BLOCKERS))
def test_stream_blocker_falls_back_to_hbm(knob, caplog, tmp_path):
    """Each option the fused stream mode does not carry trains
    device-resident with the JAX package's warning, in both packages."""
    X, y = _data(n=1200)
    extra = BLOCKERS[knob]
    if extra is None:
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 1, "threshold": 0.0}')
        extra = {knob: str(path)}
    p = {**BASE, "verbose": 0, "data_residency": "stream",
         "tpu_fused_learner": "1", **extra}
    with caplog.at_level(logging.WARNING):
        bt = lgt.Booster({**p, **CPU}, lgt.Dataset(X, label=y))
        bj = lgb.Booster({**p, "tpu_hist_impl": "onehot"},
                         lgb.Dataset(X, label=y))
    assert bt._booster.learner.residency == "hbm"
    assert bj._booster.learner.residency == "hbm"
    want = (f"data_residency=stream does not support {knob}; training "
            "device-resident")
    for name in ("lambdagap_tpu_torch", "lambdagap_tpu"):
        assert any(r.name == name and want in r.getMessage()
                   for r in caplog.records), (name, knob)


@pytest.mark.parametrize("budget,streams", [(1, True), (8, False)])
def test_auto_streams_above_the_hbm_budget(budget, streams):
    """``data_residency=auto`` with ``stream_hbm_budget_mb`` streams once
    the learner's estimated residency passes the budget, in both packages
    and both learners (4,000 x 300: fused ~2.5 MB, serial ~1.2 MB), and
    stays resident under it. Before this slice the port read no stream
    knob and trained resident."""
    rng = np.random.RandomState(3)
    X = rng.randint(0, 4, (4000, 300)).astype(float)
    y = X[:, 0] + X[:, 1] + rng.randn(4000)
    for fused in ("1", "0"):
        p = {**BASE, "num_leaves": 4, "tpu_fused_learner": fused,
             "stream_hbm_budget_mb": budget, "max_bin": 15}
        bt = lgt.Booster({**p, **CPU}, lgt.Dataset(X, label=y))
        bj = lgb.Booster({**p, "tpu_hist_impl": "onehot"},
                         lgb.Dataset(X, label=y))
        want = "stream" if streams else "hbm"
        assert bt._booster.learner.residency == want
        assert bj._booster.learner.residency == want
        assert (bt._booster.learner._estimate_residency_bytes()
                == bj._booster.learner._estimate_residency_bytes())


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_ring_on_cpu_keeps_order_and_depth(depth):
    """The CPU ring: windows come back in order with their bytes, never
    more than ``depth`` fetched ahead of the consumer, the gate called
    before each fetch; the phases add up."""
    ring = ShardRing(torch.device("cpu"), depth)
    fetched, seen, gates = [], [], []
    data = [np.arange(k * 7, dtype=np.int32).reshape(-1, 7)
            for k in range(9)]

    def windows():
        for k, a in enumerate(data):
            fetched.append(k)
            yield k, (a,)

    for k, (t,) in WindowPump(windows(), ring,
                              gate=lambda: gates.append(len(fetched))):
        assert len(fetched) - k <= depth
        seen.append(k)
        assert np.array_equal(t.numpy(), data[k])
    assert seen == list(range(9))
    assert len(gates) == 10         # one a fetch, and the exhausted one
    assert set(ring.clock.snapshot()) == {"h2d_prefetch", "chunk_wait"}
    got = []
    stream_windows(len(data), lambda c: (data[c],),
                   lambda c, t: got.append((c, t.numpy().copy())), ring)
    assert [c for c, _ in got] == list(range(9))
    assert all(np.array_equal(t, data[c]) for c, t in got)


def test_stream_rollback_equals_resident():
    """``rollback_one_iter`` after stream training subtracts the last trees
    through the binned traversal a host shard at a time: the training
    scores equal the resident booster's after its own rollback."""
    X, y = _data(n=2600)
    scores = []
    for mode in ("hbm", "stream"):
        bst = lgt.train({**BASE, **CPU, "data_residency": mode},
                        lgt.Dataset(X, label=y), 4)
        bst.rollback_one_iter()
        scores.append(bst._booster.scores.numpy().copy())
    assert np.array_equal(scores[0], scores[1])


def test_threaded_row_moves_equal_numpy():
    """Gathers and takes large enough to split over threads (more than
    2^16 rows a call) equal plain numpy indexing, across shard borders."""
    from lambdagap_tpu_torch.data.stream import row_view, take_rows
    rng = np.random.RandomState(4)
    mat = rng.randint(0, 256, (300_000, 5)).astype(np.uint8)
    sd = ShardedBinnedDataset()
    sd.shard_rows = 1 << 16
    sd.shards = [mat[lo:lo + sd.shard_rows].copy()
                 for lo in range(0, len(mat), sd.shard_rows)]
    sd.num_data = len(mat)
    sd.used_features = list(range(5))
    idx = rng.randint(0, len(mat), 250_000)
    assert np.array_equal(sd.gather_rows(idx), mat[idx])
    assert np.array_equal(sd.gather_col(2, idx), mat[idx, 2])
    rows = row_view(mat)
    assert np.array_equal(take_rows(rows, idx), rows[idx])
