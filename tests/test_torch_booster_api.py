"""The port's Booster model API against the JAX package's.

``refit`` (binary, L2 and a ranker with query groups: leaves within rtol
1e-6, predictions within rtol 1e-4 / atol 1e-5, ``decay_rate=1`` leaves
every leaf exactly as it was), ``rollback_one_iter`` (predictions and
``eval_train`` against a JAX booster trained and rolled back alike, at
the training-row bar), ``dump_model`` (``==``), ``feature_importance``
(split and gain), ``eval`` on an unregistered set with a ``feval``, leaf
output get / set (which drops the predict caches), the bounds, the split
value histogram, ``shuffle_models``, pickling and copying, and a scipy
sparse input predicted window by window; a data-file input is refused by
name.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import copy
import functools
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 0] = rng.randint(0, 10, n)
    X[::7, 2] = np.nan
    return X


@functools.lru_cache(maxsize=None)
def _model(kind):
    """(JAX booster, training rows, labels, groups or None)."""
    X = _data(600, 1)
    rng = np.random.RandomState(2)
    groups = None
    p = {"verbose": -1, "num_leaves": 7, "min_data_in_leaf": 10,
         "tpu_fast_predict_rows": 0}
    if kind == "binary":
        y = (X[:, 1] + (X[:, 0] % 3 == 0) + 0.3 * rng.randn(600) > 0.5)
        p.update(objective="binary")
    elif kind == "regression":
        y = X[:, 1] * 2.0 + np.nan_to_num(X[:, 2]) + 0.1 * rng.randn(600)
        p.update(objective="regression")
    else:
        groups = np.full(30, 20)
        y = np.clip(np.round(X[:, 1] + 1.5 + 0.3 * rng.randn(600)), 0, 4)
        p.update(objective="lambdarank", eval_at=[5])
    ds = lgb.Dataset(X, label=np.asarray(y, float), group=groups,
                     categorical_feature=[0])
    return lgb.train(p, ds, 6), X, np.asarray(y, float), groups


def _leaves(booster):
    return np.concatenate([t.leaf_value[:t.num_leaves]
                           for t in booster._booster.host_models])


@pytest.mark.parametrize("kind", ["binary", "regression", "lambdarank"])
def test_refit_equals_jax(kind):
    bst, X, y, groups = _model(kind)
    X2 = _data(500, 3)
    y2 = (y[:500] if kind != "binary" else
          (X2[:, 1] > 0).astype(float))
    g2 = None if groups is None else np.full(25, 20)
    text = bst.model_to_string()
    jax = lgb.Booster(model_str=text)
    port = lgt.Booster(model_str=text, params=CPU)
    rj = jax.refit(X2, y2, group=g2, decay_rate=0.6)
    rp = port.refit(X2, y2, group=g2, decay_rate=0.6)
    np.testing.assert_allclose(_leaves(rp), _leaves(rj), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(rp.predict(X2), rj.predict(X2), rtol=1e-4,
                               atol=1e-5)
    assert not np.array_equal(_leaves(rp), _leaves(port))
    same = port.refit(X2, y2, group=g2, decay_rate=1.0)
    assert np.array_equal(_leaves(same), _leaves(port))


def test_rollback_equals_jax():
    X = _data(800, 4)
    y = (X[:, 1] + 0.5 * (X[:, 0] % 2) > 0.2).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "is_provide_training_metric": True, "metric": "binary_logloss"}
    bj = lgb.Booster({**p, **JAX_F32}, lgb.Dataset(X, label=y))
    bp = lgt.Booster({**p, **CPU}, lgt.Dataset(X, label=y))
    for _ in range(5):
        bj.update()
        bp.update()
    for b in (bj, bp):
        b.rollback_one_iter()
        b.rollback_one_iter()
    assert bp.num_trees() == bj.num_trees() == 3
    assert bp.current_iteration == bj.current_iteration == 3
    np.testing.assert_allclose(bp.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    (_, mj, vj, _), = bj.eval_train()
    (_, mp, vp, _), = bp.eval_train()
    assert mp == mj == "binary_logloss"
    np.testing.assert_allclose(vp, vj, rtol=1e-5)
    # the rolled-back training scores are the scores of the kept trees
    fresh = lgt.Booster(model_str=bp.model_to_string(), params=CPU)
    np.testing.assert_allclose(bp._booster.scores[0].numpy(),
                               fresh.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["binary", "lambdarank"])
def test_dump_model_and_importance_equal_jax(kind):
    bst, _X, _y, _g = _model(kind)
    text = bst.model_to_string()
    jax = lgb.Booster(model_str=text)
    port = lgt.Booster(model_str=text, params=CPU)
    assert port.dump_model() == jax.dump_model()
    assert port.dump_model(num_iteration=2, start_iteration=1) == \
        jax.dump_model(num_iteration=2, start_iteration=1)
    for it in ("split", "gain"):
        assert np.array_equal(port.feature_importance(it),
                              jax.feature_importance(it))
    assert port.feature_name() == jax.feature_name()


def test_eval_on_an_unregistered_set_with_feval():
    bst, X, y, _g = _model("binary")
    params = {"metric": ["binary_logloss", "auc"]}
    jax = lgb.Booster(model_str=bst.model_to_string(), params=params)
    port = lgt.Booster(model_str=bst.model_to_string(),
                       params={**params, **CPU})

    def feval(preds, data):
        return "mean_pred", float(np.mean(preds)), False

    got = port.eval(lgt.Dataset(X, label=y), "holdout", feval=feval)
    want = jax.eval(lgb.Dataset(X, label=y), "holdout", feval=feval)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[3] for g in got] == [w[3] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6)
    # the training set of a booster answers from its own scores
    Xt = _data(300, 9)
    yt = (Xt[:, 1] > 0).astype(float)
    train = lgt.Dataset(Xt, label=yt)
    trained = lgt.train({"objective": "binary", "num_leaves": 4,
                         "verbose": -1, **CPU}, train, 2)
    (name, metric, value, _), = trained.eval(train, "train")
    assert (name, metric) == ("train", "binary_logloss")
    # (the training scores add f32(leaf x shrinkage) round by round)
    np.testing.assert_allclose(
        value, trained.eval(lgt.Dataset(Xt, label=yt), "x")[0][2], rtol=1e-6)


def test_leaf_outputs_bounds_histogram_shuffle_and_pickle():
    bst, X, _y, _g = _model("binary")
    text = bst.model_to_string()
    jax = lgb.Booster(model_str=text, params={"tpu_fast_predict_rows": 0})
    port = lgt.Booster(model_str=text, params=CPU)
    before = port.predict(X, raw_score=True)          # fills the caches
    leaf0 = port.predict(X, pred_leaf=True)[:, 0] == 0
    for b in (port, jax):
        b.set_leaf_output(0, 0, b.get_leaf_output(0, 0) + 0.5)
    after = port.predict(X, raw_score=True)
    assert port.get_leaf_output(0, 0) == jax.get_leaf_output(0, 0)
    assert (after[leaf0] != before[leaf0]).all()
    assert np.array_equal(after[~leaf0], before[~leaf0])
    assert np.array_equal(after, jax.predict(X, raw_score=True))
    assert port.lower_bound() == jax.lower_bound()
    assert port.upper_bound() == jax.upper_bound()
    hp, ep = port.get_split_value_histogram(1, bins=5)
    hj, ej = jax.get_split_value_histogram(1, bins=5)
    assert np.array_equal(hp, hj) and np.array_equal(ep, ej)
    for a, b in zip(port.get_split_value_histogram("Column_1"),
                    jax.get_split_value_histogram("Column_1")):
        assert np.array_equal(a, b)
    assert np.array_equal(
        port.get_split_value_histogram(1, xgboost_style=True),
        jax.get_split_value_histogram(1, xgboost_style=True))
    port.shuffle_models(1, 5)
    jax.shuffle_models(1, 5)
    def trees(b):
        return b.model_to_string().split("end of trees")[0]

    assert trees(port) == trees(jax)
    assert np.array_equal(port.predict(X, raw_score=True),
                          jax.predict(X, raw_score=True))
    for clone in (pickle.loads(pickle.dumps(port)), copy.copy(port),
                  copy.deepcopy(port)):
        assert clone.config.device_type == "cpu"
        assert clone.model_to_string() == port.model_to_string()
        assert np.array_equal(clone.predict(X), port.predict(X))


def test_sparse_input_and_file_refusal(tmp_path):
    bst, X, _y, _g = _model("regression")
    port = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    Xs = np.nan_to_num(X)
    Xs[np.abs(Xs) < 0.5] = 0.0
    dense = port.predict(Xs, pred_contrib=True)
    assert np.array_equal(port.predict(sp.csr_matrix(Xs), pred_contrib=True),
                          dense)
    assert np.array_equal(port.predict(sp.csr_matrix(Xs)), port.predict(Xs))
    path = tmp_path / "rows.tsv"
    np.savetxt(path, Xs, delimiter="\t")
    with pytest.raises(NotImplementedError, match="data file"):
        port.predict(str(path))
