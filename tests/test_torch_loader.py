"""The port's text / binary loader (``lambdagap_tpu_torch/data/loader.py``)
held to the JAX package's (``lambdagap_tpu/data/loader.py``) on the same
files: parsed matrices, labels, weights, groups, sidecars and feature
names ``array_equal`` (NaN-aware), binned matrices ``array_equal``, and a
model trained from a path within rtol 1e-4 / atol 1e-5 of the JAX
package's (``tests/test_fused.py:54``). The files are small: the parses
and bins are exact at any size.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import io
import os
import pickle

import numpy as np
import pytest

import lambdagap_tpu as lgb
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data import loader as jl
import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data import loader as pl

CPU = {"device_type": "cpu"}


def _cfgs(**params):
    params = {"verbose": -1, **params}
    return Config.from_params({**params, **CPU}), JaxConfig.from_params(params)


def _r(v) -> str:
    return repr(float(v))


def _data(n=400, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.03, 2] = np.inf
    X[rng.rand(n) < 0.3, 3] = 0.0
    X[:, 4] = rng.randint(0, 6, n)
    y = (np.nan_to_num(X[:, 0]) + 0.3 * X[:, 4] > 0.5).astype(float)
    return X, y


def _write_csv(path, X, y, header=True, tsv=False):
    """label, a, b, w, c, d, e (the weight in column 3); a NaN is written
    as ``NA`` or ``nan``, row by row."""
    d = "\t" if tsv else ","
    w = 1.0 + (np.arange(len(y)) % 4)
    with open(path, "w") as f:
        if header:
            f.write(d.join(["lab", "a", "b", "w", "c", "d", "e"]) + "\n")
        for i in range(len(y)):
            vals = [("NA" if i % 2 else "nan") if np.isnan(v) else _r(v)
                    for v in X[i]]
            f.write(d.join([_r(y[i])] + vals[:2] + [_r(w[i])] + vals[2:])
                    + "\n")
    return w


def _write_svm(path, X, y, qid=None, prec=None):
    with open(path, "w") as f:
        for i in range(len(y)):
            toks = [_r(y[i])] + ([f"qid:{qid[i]}"] if qid is not None else [])
            toks += [f"{j}:{_r(X[i, j]) if prec is None else f'{X[i, j]:{prec}}'}"
                     for j in range(X.shape[1])
                     if X[i, j] != 0 and not np.isnan(X[i, j])]
            f.write(" ".join(toks) + "\n")


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


def _same_dataset(p, j):
    np.testing.assert_array_equal(p.binned, j.binned)
    assert p.used_features == j.used_features
    assert p.feature_num_bins == j.feature_num_bins
    assert p.feature_names == j.feature_names
    assert p.num_total_features == j.num_total_features
    for k in ("label", "weight", "query_boundaries", "init_score",
              "position"):
        _same(getattr(p.metadata, k), getattr(j.metadata, k))


@pytest.mark.parametrize("kind", ["csv_header", "tsv", "libsvm",
                                  "libsvm_qid"])
def test_text_files_parse_and_bin_as_jax(kind, tmp_path):
    """One-round parses: CSV with a header, ``name:`` label / weight /
    ignore columns and NA / nan / inf tokens; TSV; LibSVM with and without
    ``qid:``; the ``.init`` / ``.position`` / ``.query`` sidecars."""
    X, y = _data()
    params = {}
    if kind.startswith("libsvm"):
        path = str(tmp_path / "d.svm")
        qid = np.arange(len(y)) // 40 if kind == "libsvm_qid" else None
        _write_svm(path, X, y, qid)
    else:
        path = str(tmp_path / ("d.csv" if kind == "csv_header" else "d.tsv"))
        _write_csv(path, X, y, header=kind == "csv_header",
                   tsv=kind == "tsv")
        params = ({"header": True, "label_column": "name:lab",
                   "weight_column": "name:w", "ignore_column": "name:e"}
                  if kind == "csv_header" else {"weight_column": "3"})
    np.savetxt(path + ".init", np.linspace(-1, 1, len(y)))
    np.savetxt(path + ".position", np.arange(len(y)) % 3, fmt="%d")
    if kind == "tsv":
        np.savetxt(path + ".query", [100, 150, 150], fmt="%d")
    pc, jc = _cfgs(**params)
    assert pl.detect_format(path) == jl.detect_format(path)
    got = pl._parse_text_file(path, pc)
    want = jl._parse_text_file(path, jc)
    for a, b in zip(got, want):
        _same(a, b)
    _same_dataset(pl.load_data_file(path, pc), jl.load_data_file(path, jc))


def test_delimited_fields_read_as_the_native_parser(tmp_path):
    """Empty, NA, non-numeric and short rows: an empty field inside a line
    reads 0.0 and an empty last or missing field NaN, in both packages'
    one-round parse (``native/parser.cpp:183-190``). A ``#`` line is
    skipped by every port path; the JAX package's one-round parse reads
    it as a row while its block reader skips it (ROADMAP.md, Queue 3)."""
    path = str(tmp_path / "odd.csv")
    rows = ["1,NA,,inf,-inf, 2.5 ,nan,abc,1.5x,\n", "0,3,4\n", "\n",
            "1,1e3,-0.0,5,6,7,8,9,10,11,12\n"]
    with open(path, "w") as f:
        f.writelines(rows)
    np.testing.assert_array_equal(pl._load_delim(path, ",", False),
                                  jl._load_delim(path, ",", False))
    M = pl._load_delim(path, ",", False)
    assert M.shape == (3, 10) and M[0, 2] == 0.0 and np.isnan(M[0, 9])
    with open(path, "w") as f:
        f.writelines(rows[:2] + ["# a comment line\n"] + rows[2:])
    np.testing.assert_array_equal(pl._load_delim(path, ",", False), M)
    np.testing.assert_array_equal(
        np.concatenate(list(pl.iter_predict_blocks(path, _cfgs()[0], 2))),
        M[:, 1:])


def test_malformed_libsvm_fails_in_both_packages(tmp_path):
    path = str(tmp_path / "bad.svm")
    with open(path, "w") as f:
        f.write("1 0:1.0 2:0.5\n1 0:1.0 junk 2:0.5\n")
    pc, jc = _cfgs()
    with pytest.raises(RuntimeError, match="LibSVM format error"):
        jl.load_data_file(path, jc)
    with pytest.raises(RuntimeError, match="LibSVM format error"):
        pl.load_data_file(path, pc)
    with pytest.raises(RuntimeError, match="LibSVM format error"):
        pl.load_data_file(path, Config.from_params({**CPU, "two_round": True,
                                                    "verbose": -1}))


@pytest.mark.parametrize("kind", ["csv", "libsvm_qid"])
def test_two_round_equals_one_round_and_jax(kind, tmp_path):
    """``two_round=true``: every row through the sketches (exact below the
    budget), each 65,536-row chunk parsed again and binned — the same
    bins and metadata as the one-round load and as the JAX package's
    two-round load; the ``stream_ingest_threshold_mb`` route takes it
    for a file past the threshold."""
    rng = np.random.RandomState(2)
    n = 12000
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.2, 3] = 0.0
    y = (X[:, 0] - X[:, 1] > 0).astype(float)
    if kind == "csv":
        path = str(tmp_path / "d.csv")
        _write_csv(path, X[:, :5], y)
        params = {"header": True, "weight_column": "name:w"}
    else:
        path = str(tmp_path / "d.svm")
        _write_svm(path, X, y, qid=np.arange(n) // 40)
        params = {}
    assert os.path.getsize(path) > 1 << 20
    one_p, one_j = _cfgs(**params)
    two_p, two_j = _cfgs(**params, two_round=True)
    thr_p, thr_j = _cfgs(**params, stream_ingest_threshold_mb=1)
    one = pl.load_data_file(path, one_p)
    two = pl.load_data_file(path, two_p)
    _same_dataset(two, one)
    _same_dataset(two, jl.load_data_file(path, two_j))
    _same_dataset(pl.load_data_file(path, thr_p),
                  jl.load_data_file(path, thr_j))
    # a validation file binned on the training mappers, two-round
    va_p = pl.load_data_file(path, two_p, reference=one)
    va_j = jl.load_data_file(path, two_j, reference=jl.load_data_file(
        path, one_j))
    _same_dataset(va_p, va_j)


@pytest.mark.parametrize("kind", ["csv", "libsvm"])
def test_iter_predict_blocks_equal_the_whole_parse(kind, tmp_path):
    X, y = _data(n=300)
    if kind == "csv":
        path = str(tmp_path / "d.csv")
        _write_csv(path, X, y)
        params = {"header": True, "weight_column": "name:w"}
    else:
        path = str(tmp_path / "d.svm")
        X[:, 4] = 0.0          # the last feature index never appears
        _write_svm(path, X, y)
        params = {}
    pc, jc = _cfgs(**params)
    whole = pl._parse_text_file(path, pc)[0]
    blocks = list(pl.iter_predict_blocks(path, pc, block_rows=64))
    assert [b.shape[0] for b in blocks] == [64] * 4 + [44]
    np.testing.assert_array_equal(np.concatenate(blocks), whole)
    jblocks = list(jl.iter_predict_blocks(path, jc, block_rows=64))
    np.testing.assert_array_equal(np.concatenate(blocks),
                                  np.concatenate(jblocks))
    assert pl._libsvm_predict_width(path) == jl._libsvm_predict_width(path) \
        if kind == "libsvm" else True


def test_jax_written_binary_cache_loads_in_the_port(tmp_path):
    """A ``.bin`` the JAX package writes loads in the port (its pickled
    mappers become the port's BinMapper) and trains as the same matrix;
    the port's cache loads in the JAX package; any other pickled global
    is refused."""
    X, y = _data(n=600)
    path = str(tmp_path / "d.csv")
    _write_csv(path, X, y)
    pc, jc = _cfgs(header=True, weight_column="name:w")
    jds = jl.load_data_file(path, jc)
    jl.save_binary(jds, str(tmp_path / "j.bin"))
    got = pl.load_binary(str(tmp_path / "j.bin.npz"))
    _same_dataset(got, jds)
    assert type(got.mappers[0]).__module__ == \
        "lambdagap_tpu_torch.data.binning"
    pl.save_binary(got, str(tmp_path / "p.bin"))
    _same_dataset(jl.load_binary(str(tmp_path / "p.bin.npz")), jds)
    # a cache file named *.bin loads through load_data_file
    os.rename(str(tmp_path / "p.bin.npz"), str(tmp_path / "q.bin"))
    _same_dataset(pl.load_data_file(str(tmp_path / "q.bin"), pc), jds)
    params = {**CPU, "objective": "binary", "num_leaves": 7, "verbose": -1}
    a = lgt.train(params, lgt.Dataset(got), 3).model_to_string()
    b = lgt.train(params, lgt.Dataset(pl.load_data_file(path, pc)),
                  3).model_to_string()
    assert a == b

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    z = dict(np.load(str(tmp_path / "j.bin.npz")))
    z["mappers"] = np.frombuffer(pickle.dumps([Evil()]), np.uint8)
    np.savez_compressed(str(tmp_path / "evil.npz"), **z)
    with pytest.raises(pickle.UnpicklingError, match="refusing global"):
        pl.load_binary(str(tmp_path / "evil.npz"))


def test_dataset_from_a_path_trains_predicts_and_evaluates_as_jax(tmp_path):
    """``Dataset(path)`` with a categorical feature named against the
    header trains as the JAX package's; ``predict(path)``, ``eval`` of a
    path Dataset and ``refit(path)`` read the file's rows."""
    X, y = _data(n=800)
    path = str(tmp_path / "d.csv")
    w = _write_csv(path, X, y)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "header": True, "weight_column": "name:w",
              "min_data_in_leaf": 5}
    pb = lgt.train({**params, **CPU},
                   lgt.Dataset(path, categorical_feature=["e"]), 5)
    jb = lgb.train(params, lgb.Dataset(path, categorical_feature=["e"]), 5)
    assert pb._booster.train_set.mappers[4].bin_type == "categorical"
    np.testing.assert_allclose(pb.predict(path), jb.predict(path),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pb.predict(path), pb.predict(X))
    np.testing.assert_array_equal(pb._booster.train_set.metadata.weight,
                                  w.astype(np.float32))
    ev = pb.eval(lgt.Dataset(path, free_raw_data=False), "file")
    want = pb.eval(lgt.Dataset(X, label=y, weight=w), "file")
    assert ev == want and ev[0][1] == "binary_logloss"
    r1 = pb.refit(path)
    r2 = pb.refit(X, y, weight=w)
    assert r1.model_to_string() == r2.model_to_string()
