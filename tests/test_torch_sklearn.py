"""The port's scikit-learn wrappers against the JAX package's.

``LGBMRegressor``, ``LGBMClassifier`` (binary and 3-class) and
``LGBMRanker`` fit on the CPU and predict what the JAX wrappers predict on
the training rows at the trained-model bar (rtol 1e-4 / atol 1e-5; the
JAX side with full-f32 one-hot histograms), ``predict_proba`` and class
labels included; ``pred_leaf`` / ``pred_contrib`` pass through
``predict``, the contributions summing to the raw scores. A callable
objective or eval metric is refused by name.
"""
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
BAR = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(n_estimators=6, num_leaves=7, min_child_samples=10)


def _data(n=500, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    return X, rng


@pytest.mark.parametrize("classes", [2, 3])
def test_classifier_equals_jax(classes):
    X, rng = _data()
    y = np.array(["a", "b", "c"])[
        (X[:, 0] > 0).astype(int) + (classes == 3) * (X[:, 1] > 0.5)]
    cp = lgt.LGBMClassifier(**SMALL, **CPU).fit(X, y)
    cj = lgb.LGBMClassifier(**SMALL, **JAX_F32).fit(X, y)
    assert list(cp.classes_) == list(cj.classes_)
    np.testing.assert_allclose(cp.predict_proba(X), cj.predict_proba(X),
                               **BAR)
    assert np.array_equal(cp.predict(X), cj.predict(X))
    np.testing.assert_allclose(cp.predict(X, raw_score=True),
                               cj.predict(X, raw_score=True), **BAR)
    contrib = cp.predict(X, pred_contrib=True)
    assert contrib.shape == (len(X), (1 if classes == 2 else 3) * 6)
    np.testing.assert_allclose(
        contrib.reshape(len(X), -1, 6).sum(axis=2).squeeze(),
        cp.predict(X, raw_score=True), rtol=1e-5, atol=1e-6)
    assert cp.predict(X, pred_leaf=True).shape == \
        (len(X), cp.n_estimators_ * (1 if classes == 2 else 3))
    assert cp.n_features_in_ == 5
    # (split counts are not held to the JAX wrapper's: tied thresholds
    # that route every training row alike may split other features)
    assert np.array_equal(cp.feature_importances_,
                          cp.booster_.feature_importance("split"))


def test_regressor_and_ranker_equal_jax():
    X, rng = _data()
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + 0.1 * rng.randn(len(X))
    rp = lgt.LGBMRegressor(**SMALL, **CPU).fit(X, y)
    rj = lgb.LGBMRegressor(**SMALL, **JAX_F32).fit(X, y)
    np.testing.assert_allclose(rp.predict(X), rj.predict(X), **BAR)
    leaves = rp.predict(X, pred_leaf=True)
    assert np.array_equal(
        leaves, rp.booster_.predict(X, pred_leaf=True))
    rel = np.clip(np.round(X[:, 0] + 1.5), 0, 3)
    group = np.full(25, 20)
    kp = lgt.LGBMRanker(**SMALL, **CPU).fit(X, rel, group=group)
    kj = lgb.LGBMRanker(**SMALL, **JAX_F32).fit(X, rel, group=group)
    np.testing.assert_allclose(kp.predict(X), kj.predict(X), **BAR)
    assert kp.get_params()["num_leaves"] == 7


def test_callables_are_refused_by_name():
    X, _ = _data(60)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(NotImplementedError, match="callable objective"):
        lgt.LGBMRegressor(objective=lambda y, p: (p - y, np.ones_like(p)),
                          **CPU).fit(X, y)
    with pytest.raises(NotImplementedError, match="eval_metric"):
        lgt.LGBMClassifier(n_estimators=2, **CPU).fit(
            X, y, eval_set=[(X, y)],
            eval_metric=lambda y, p: ("e", 0.0, False))
    with pytest.raises(RuntimeError, match="not fitted"):
        lgt.LGBMRegressor().predict(X)
