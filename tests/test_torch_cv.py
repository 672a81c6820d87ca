"""Cross-validation (``lgt.cv``, ``CVBooster``) on the CPU, held to the
JAX package's ``cv`` on the same numpy inputs: the folds, the mean and
standard-deviation histories at rtol 1e-4, early stopping on the first
metric, an sklearn splitter with ``eval_train_metric``
(``tests/test_misc_api.py:42-68``'s cases), and a ranker's folds, which
fail in both packages because ``Dataset.subset`` carries no groups
(ROADMAP.md, Queue 3).

The features are few-valued: a fold's metric is taken on its held-out
rows, and a threshold tied across bins that hold no training row would
route a held-out row at the two packages' whim. The histories are
compared with ``boost_from_average=false``: the JAX fused path counts the
init score twice on validation scores (ROADMAP.md, Queue 3).
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.engine import _make_n_folds as jax_folds
from lambdagap_tpu_torch.engine import _make_n_folds as port_folds

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}


def _data(n=900, d=6, seed=4):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d) * 2) / 2
    z = X @ rng.randn(d) + 0.3 * X[:, 0] * X[:, 1] + 0.3 * rng.randn(n)
    return X, z


def _cv_both(params, X, y, rounds, **kw):
    params = {**params, "boost_from_average": False}
    rj = lgb.cv({**params, **JAX_F32},
                lgb.Dataset(X, label=y, free_raw_data=False), rounds, **kw)
    rt = lgt.cv({**params, **CPU},
                lgt.Dataset(X, label=y, free_raw_data=False), rounds, **kw)
    return rj, rt


def _same_history(rt, rj):
    assert sorted(rt) == sorted(rj)
    for key in rj:
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("stratified, shuffle", [(True, True),
                                                 (False, False)])
def test_folds_equal_jax(stratified, shuffle):
    X, z = _data()
    y = (z > 0).astype(np.float64)
    params = {"objective": "binary", "verbose": -1}
    got = list(port_folds(lgt.Dataset(X, label=y), 4, {**params, **CPU}, 7,
                          stratified, shuffle))
    want = list(jax_folds(lgb.Dataset(X, label=y), 4, params, 7,
                          stratified, shuffle))
    assert len(got) == len(want) == 4
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def test_binary_stratified_cv_matches_jax():
    X, z = _data()
    y = (z > 0).astype(np.float64)
    params = {"objective": "binary", "metric": ["binary_logloss", "auc"],
              "num_leaves": 7, "verbose": -1}
    rj, rt = _cv_both(params, X, y, 4, nfold=3)
    _same_history(rt, rj)
    assert len(rt["valid binary_logloss-mean"]) == 4


def test_regression_cv_with_a_splitter_and_train_metric_matches_jax():
    pytest.importorskip("sklearn")
    from sklearn.model_selection import KFold
    X, z = _data()
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
              "metric": "l2"}
    rj, rt = _cv_both(params, X, z, 5, folds=KFold(n_splits=3),
                      eval_train_metric=True)
    _same_history(rt, rj)
    assert "train l2-mean" in rt and len(rt["valid l2-mean"]) == 5
    assert np.mean(rt["train l2-mean"]) <= np.mean(rt["valid l2-mean"])


def test_cv_early_stopping_on_the_first_metric_matches_jax():
    X, z = _data()
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
              "metric": ["l2", "l1"], "early_stopping_round": 3,
              "learning_rate": 0.5}
    rj, rt = _cv_both(params, X, z, 30, nfold=3)
    assert len({len(v) for v in rt.values()}) == 1
    _same_history(rt, rj)


def test_cvbooster_holds_the_folds():
    """The mean history is the mean of the folds' own evaluations, and a
    method called on the CVBooster is called on every fold's booster."""
    X, z = _data()
    y = (z > 0).astype(np.float64)
    res = lgt.cv({"objective": "binary", "metric": "binary_logloss",
                  "num_leaves": 7, "verbose": -1, **CPU},
                 lgt.Dataset(X, label=y, free_raw_data=False), 3, nfold=3,
                 return_cvbooster=True)
    cvb = res["cvbooster"]
    assert isinstance(cvb, lgt.CVBooster) and len(cvb.boosters) == 3
    folds = [ev[0][2] for ev in cvb.eval_valid()]
    assert res["valid binary_logloss-mean"][-1] == pytest.approx(
        np.mean(folds), rel=1e-12)
    assert cvb.num_trees() == [3, 3, 3]
    preds = cvb.predict(X[:5])
    assert len(preds) == 3 and all(p.shape == (5,) for p in preds)


def test_ranking_folds_fail_as_in_jax():
    """Group-aware folds split whole queries, but ``subset`` does not
    carry the groups, so a ranker's fold has none in both packages."""
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5)
    y = rng.randint(0, 3, 300).astype(float)
    params = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [5],
              "verbose": -1}
    for mod, extra in ((lgb, {}), (lgt, CPU)):
        with pytest.raises(RuntimeError,
                           match="Ranking tasks require query information"):
            mod.cv({**params, **extra},
                   mod.Dataset(X, label=y, group=[20] * 15,
                               free_raw_data=False), 2, nfold=3)
