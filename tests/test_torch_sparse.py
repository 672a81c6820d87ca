"""scipy sparse inputs in the port (``basic._CSRSequence``), held to their
dense twin and to the JAX package on the same seeded matrix: a CSR, CSC
or COO training matrix bins through the streaming path into the dense
twin's bins (every row seen, so the bins equal the dense twin's whole-data
bins), trains the same model byte for byte, and predicts as the dense
matrix in windows; the JAX package trains the same model within rtol
1e-4 / atol 1e-5 (``tests/test_fused.py:54``).
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

sp = pytest.importorskip("scipy.sparse")

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 5}


def _sparse(n=2000, d=12, density=0.1, seed=0):
    rng = np.random.RandomState(seed)
    X = sp.random(n, d, density=density, format="csr", random_state=rng,
                  data_rvs=lambda k: np.round(rng.randn(k) * 2, 3))
    dense = X.toarray()
    y = (dense[:, 0] + dense[:, 1] - 0.2 * dense[:, 2] > 0).astype(float)
    return X, dense, y


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_training_equals_the_dense_twin_and_jax(fmt):
    X, dense, y = _sparse()
    Xf = X.asformat(fmt)
    ds = lgt.Dataset(Xf, label=y, params={**PARAMS, **CPU}).construct()
    twin = lgt.Dataset(dense, label=y, params={**PARAMS, **CPU}).construct()
    np.testing.assert_array_equal(ds.binned, twin.binned)
    b_sp = lgt.train({**PARAMS, **CPU}, lgt.Dataset(Xf, label=y), 5)
    b_de = lgt.train({**PARAMS, **CPU}, lgt.Dataset(dense, label=y), 5)
    assert b_sp.model_to_string() == b_de.model_to_string()
    np.testing.assert_array_equal(b_sp.predict(Xf), b_de.predict(dense))
    jb = lgb.train(PARAMS, lgb.Dataset(Xf, label=y), num_boost_round=5)
    np.testing.assert_allclose(b_sp.predict(dense), jb.predict(dense),
                               rtol=1e-4, atol=1e-5)
    jds = lgb.Dataset(Xf, label=y, params=PARAMS).construct()
    np.testing.assert_array_equal(ds.binned, jds.binned)


def test_sparse_predict_windows_and_contrib(monkeypatch):
    """Prediction of a sparse matrix densifies 65,536-row windows; every
    output kind equals the dense matrix's."""
    X, dense, y = _sparse(n=700)
    bst = lgt.train({**PARAMS, **CPU}, lgt.Dataset(dense, label=y), 3)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"pred_contrib": True}):
        np.testing.assert_array_equal(bst.predict(X.tocsc(), **kw),
                                      bst.predict(dense, **kw))
