"""DART and random-forest boosting (``models/dart.py``) on the CPU, held
to the JAX package's on the same numpy inputs: predictions on the
training rows at rtol 1e-4 / atol 1e-5. DART's drop and renormalization
and RF's running average replay whole forests over the binned matrices;
the booster's own scores must stay what its trees predict, and a served
model must answer with the renormalized leaves.

The JAX side runs its fused learner with full-f32 one-hot histograms,
except RF with ``regression_l1``: the JAX fused learner keeps no leaf
permutation, so its RF leaf renewal fails there (ROADMAP.md, Queue 3), and
the JAX side runs its serial learner instead.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
BAR = {"rtol": 1e-4, "atol": 1e-5}
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "learning_rate": 0.1, "verbose": -1}


def _data(n=800, d=8, seed=3, levels=0):
    """Gaussian features; with ``levels``, each rounded to that many steps
    a unit (few-valued features: under bagging no threshold is tied across
    bins that hold only out-of-bag rows, ROADMAP.md Queue 3)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    if levels:
        X = np.round(X * levels) / levels
    z = X @ rng.randn(d) + 0.3 * X[:, 0] * X[:, 1] + 0.3 * rng.randn(n)
    return X, z


def _both(params, X, y, rounds, **kw):
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), rounds,
                   **kw)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), rounds, **kw)
    return bj, bt


def _scores_are_the_model(bst, X):
    """The booster's training scores equal what its trees predict."""
    gb = bst._booster
    np.testing.assert_allclose(gb.scores[0].numpy(),
                               bst.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("extra", [
    {"drop_rate": 0.3, "skip_drop": 0.3},
    {"drop_rate": 0.5, "skip_drop": 0.0, "xgboost_dart_mode": True},
    {"drop_rate": 0.5, "skip_drop": 0.0, "uniform_drop": True},
    {"drop_rate": 0.8, "skip_drop": 0.0, "max_drop": 2, "drop_seed": 9},
])
def test_dart_matches_jax(extra):
    X, z = _data()
    y = (z > 0).astype(np.float64)
    params = {**BASE, "boosting": "dart", **extra}
    bj, bt = _both(params, X, y, 6)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), **BAR)
    gt, gj = bt._booster, bj._booster
    np.testing.assert_allclose(gt.tree_weight, gj.tree_weight, rtol=1e-6)
    assert gt.sum_weight == pytest.approx(gj.sum_weight, rel=1e-6)
    _scores_are_the_model(bt, X)
    assert bt.num_trees() == 6


def test_dart_on_efb_bundles_matches_jax():
    """The learner trains over EFB bundle columns; the replays run over
    the per-feature matrix, uploaded once."""
    rng = np.random.RandomState(17)
    which = rng.randint(0, 6, 1500)
    X = np.zeros((1500, 6))
    X[np.arange(1500), which] = rng.rand(1500) + 0.5
    y = X.sum(1) * (1 + which % 3) + rng.randn(1500) * 0.1
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
    bj, bt = _both(params, X, y, 6)
    gb = bt._booster
    assert gb.learner.x_rows.shape[1] < 6 and gb._x_binned is not None
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), **BAR)
    _scores_are_the_model(bt, X)


def test_dart_continued_from_a_model_matches_jax():
    """tests/test_continued.py:85: weighted dropout resumes with its tree
    weights rebuilt from the trees' shrinkage."""
    X, z = _data(n=400)
    y = (z > 0).astype(np.float64)
    params = {**BASE, "boosting": "dart", "drop_rate": 0.5,
              "uniform_drop": False, "skip_drop": 0.0}
    bj, bt = _both(params, X, y, 5)
    rj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 5,
                   init_model=bj)
    rt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5,
                   init_model=bt)
    assert rt.num_trees() == 10 and np.isfinite(rt.predict(X)).all()
    np.testing.assert_allclose(rt.predict(X, raw_score=True),
                               rj.predict(X, raw_score=True), **BAR)
    np.testing.assert_allclose(rt._booster.tree_weight,
                               rj._booster.tree_weight, rtol=1e-6)


def test_dart_serves_the_renormalized_leaves():
    """A round's renormalization changes earlier trees in place: the
    booster's predict caches and a server built from it answer with the
    new leaves, equal to a booster reloaded from the model text."""
    X, z = _data()
    y = (z > 0).astype(np.float64)
    bst = lgt.Booster(params={**BASE, **CPU, "boosting": "dart",
                              "drop_rate": 0.9, "skip_drop": 0.0},
                      train_set=lgt.Dataset(X, label=y))
    for _ in range(3):
        bst.update()
    before = bst.predict(X, raw_score=True)
    gen = bst._booster.generation
    bst.update()
    assert bst._booster.generation > gen
    after = bst.predict(X, raw_score=True)
    fresh = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    np.testing.assert_array_equal(after, fresh.predict(X, raw_score=True))
    assert not np.array_equal(before, after)
    with bst.as_server(raw_score=True) as server:
        np.testing.assert_array_equal(server.predict(X), after)
    _scores_are_the_model(bst, X)


def _nan_label():
    X, z = _data()
    y = z.copy()
    y[[3, 50, 700]] = np.nan
    return X, y


def test_dart_skip_tree_matches_jax():
    """A NaN label makes every round's gradients non-finite: skip_tree
    drops each round in both packages, the dropout undone."""
    X, y = _nan_label()
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
              "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
              "guard_nonfinite": "skip_tree", "boost_from_average": False}
    bj, bt = _both(params, X, y, 4)
    gt, gj = bt._booster, bj._booster
    assert len(gt.models) == len(gj.models) == 0
    assert gt.iter_ == gj.iter_ == 0 and gt.last_iteration_skipped
    assert gt.tree_weight == gj.tree_weight == []
    assert np.isfinite(gt.scores.numpy()).all()


def test_dart_late_skip_tree_undoes_the_renormalization():
    """Scores a round left non-finite are found by the next round: the
    restore puts back the state from before that round, the dropped
    trees' leaves and tree weights included, and the round is grown again
    on the booster's consistent state."""
    X, z = _data()
    y = (z > 0).astype(np.float64)
    params = {**BASE, **CPU, "boosting": "dart", "drop_rate": 0.9,
              "skip_drop": 0.0, "guard_nonfinite": "skip_tree"}
    bst = lgt.Booster(params=params, train_set=lgt.Dataset(X, label=y))
    for _ in range(2):
        bst.update()
    gb = bst._booster
    leaves = [gb._tree(i).leaf_value.copy() for i in range(2)]
    weights = (list(gb.tree_weight), gb.sum_weight)
    bst.update()        # round 2 renormalizes the trees it dropped
    assert any(not np.array_equal(gb._tree(i).leaf_value, leaves[i])
               for i in range(2))
    gb.scores[0, 5] = float("inf")
    gb.guard._unchecked = True
    seen = {}
    restore = gb._guard_state_restore

    def spy(st, rng=None):
        restore(st, rng)
        seen["leaves"] = [gb._tree(i).leaf_value.copy() for i in range(2)]
        seen["weights"] = (list(gb.tree_weight), gb.sum_weight)
    gb._guard_state_restore = spy
    assert bst.update() is False
    for got, want in zip(seen["leaves"], leaves):
        np.testing.assert_array_equal(got, want)
    assert seen["weights"] == weights
    assert gb.iter_ == 3 and len(gb.models) == 3
    assert len(gb.tree_weight) == 3
    assert gb.sum_weight == pytest.approx(sum(gb.tree_weight), rel=1e-12)
    _scores_are_the_model(bst, X)


@pytest.mark.parametrize("objective", ["regression", "regression_l1"])
def test_rf_matches_jax(objective):
    X, z = _data(levels=2)
    params = {"objective": objective, "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 10, "boosting": "rf",
              "bagging_fraction": 0.5, "bagging_freq": 1,
              "feature_fraction": 0.8}
    jax_side = ({**params, **JAX_F32} if objective == "regression" else
                {**params, **JAX_F32, "tpu_fused_learner": "0"})
    bj = lgb.train(jax_side, lgb.Dataset(X, label=z), 6)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=z), 6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), **BAR)
    assert bt._booster.average_output and bt.num_trees() == 6
    assert "average_output" in bt.model_to_string()
    _scores_are_the_model(bt, X)
    reloaded = lgt.Booster(model_str=bt.model_to_string(), params=CPU)
    np.testing.assert_array_equal(reloaded.predict(X), bt.predict(X))


def test_rf_continued_from_a_model_matches_jax():
    X, z = _data(levels=2)
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1}
    bj, bt = _both(params, X, z, 3)
    rj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=z), 3,
                   init_model=bj)
    rt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=z), 3,
                   init_model=bt)
    assert rt.num_trees() == 6
    np.testing.assert_allclose(rt.predict(X), rj.predict(X), **BAR)
    _scores_are_the_model(rt, X)


def test_rf_without_sampling_fails_like_jax():
    X, z = _data(n=200)
    with pytest.raises(RuntimeError, match="needs bagging"):
        lgb.train({"objective": "regression", "boosting": "rf",
                   "verbose": -1}, lgb.Dataset(X, label=z), 2)
    with pytest.raises(RuntimeError, match="needs bagging"):
        lgt.train({"objective": "regression", "boosting": "rf",
                   "verbose": -1, **CPU}, lgt.Dataset(X, label=z), 2)
