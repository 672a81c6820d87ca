"""Arrow inputs in the port (``basic._arrow_table_to_matrix``), held to the
numpy twin and to the JAX package: a chunked Table trains as its matrix,
Arrow arrays carry the label, weight, group, position and init score,
nulls read as NaN, dictionary columns are categorical, and the JAX
package trains the same models within rtol 1e-4 / atol 1e-5. pyarrow is
optional in both packages (the card machine has none), so these skip
where it is missing.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import lambdagap_tpu as lgb  # noqa: E402
import lambdagap_tpu_torch as lgt  # noqa: E402

CPU = {"device_type": "cpu"}


def _table(X, types=None, n_chunks=3):
    n, d = X.shape
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)
    cols = []
    for j in range(d):
        typ = (types or {}).get(j, pa.float64())
        cols.append(pa.chunked_array(
            [pa.array(X[a:b, j], type=typ, from_pandas=True)
             for a, b in zip(bounds[:-1], bounds[1:])]))
    return pa.table(cols, names=[f"f{j}" for j in range(d)])


def _trees(bst) -> str:
    """The model text's trees (the names differ: the Table's schema)."""
    text = bst.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


def test_table_trains_as_its_matrix_and_as_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(1200, 6)
    X[:, 2] = rng.randint(0, 30, 1200)
    X[rng.rand(1200) < 0.1, 3] = np.nan       # nulls
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    w = rng.rand(1200) + 0.5
    table = _table(X, types={2: pa.int32()})
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5}
    label = pa.chunked_array([y[:500], y[500:]])
    b_pa = lgt.train({**params, **CPU},
                     lgt.Dataset(table, label=label, weight=pa.array(w)), 6)
    b_np = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y, weight=w), 6)
    assert _trees(b_pa) == _trees(b_np)
    assert b_pa.feature_name() == [f"f{j}" for j in range(6)]
    np.testing.assert_array_equal(b_pa.predict(table), b_pa.predict(X))
    jb = lgb.train(params, lgb.Dataset(table, label=label,
                                       weight=pa.array(w)), 6)
    np.testing.assert_allclose(b_pa.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_arrow_groups_positions_init_scores_and_dictionaries():
    """A ranker's groups and positions and a class-major init-score table
    arrive as Arrow; a dictionary column is categorical."""
    rng = np.random.RandomState(1)
    n = 600
    X = rng.randn(n, 4)
    codes = rng.randint(0, 5, n)
    cat = pa.DictionaryArray.from_arrays(
        pa.array(codes, type=pa.int32()),
        pa.array(["a", "b", "c", "d", "e"]))
    table = pa.table({"x0": X[:, 0], "x1": X[:, 1], "c": cat})
    y = rng.randint(0, 3, n).astype(float)
    groups = np.full(30, 20)
    pos = np.tile(np.arange(20), 30)
    params = {"objective": "lambdarank", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5}
    pds = lgt.Dataset(table, label=pa.array(y), group=pa.array(groups),
                      position=pa.array(pos), params={**params, **CPU}
                      ).construct()
    jds = lgb.Dataset(table, label=pa.array(y), group=pa.array(groups),
                      position=pa.array(pos), params=params).construct()
    np.testing.assert_array_equal(pds.binned, jds.binned)
    np.testing.assert_array_equal(pds.metadata.query_boundaries,
                                  jds.metadata.query_boundaries)
    np.testing.assert_array_equal(pds.metadata.position, pos)
    assert pds.mappers[2].bin_type == "categorical"
    pb = lgt.train({**params, **CPU}, lgt.Dataset(
        table, label=pa.array(y), group=pa.array(groups)), 3)
    jb = lgb.train(params, lgb.Dataset(
        table, label=pa.array(y), group=pa.array(groups)), 3)
    np.testing.assert_allclose(pb.predict(table), jb.predict(table),
                               rtol=1e-4, atol=1e-5)
    # init scores: a 3-column table is class-major
    init = rng.randn(n, 3)
    ds = lgt.Dataset(X, label=rng.randint(0, 3, n).astype(float),
                     init_score=pa.table({f"k{k}": init[:, k]
                                          for k in range(3)}),
                     params={"objective": "multiclass", "num_class": 3,
                             **CPU}).construct()
    np.testing.assert_array_equal(ds.metadata.init_score,
                                  init.T.reshape(-1))
