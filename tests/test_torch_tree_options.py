"""The device learner's tree options on the CPU, held to the JAX package's
fused learner (``tpu_fused_learner=1``, one-hot f32 histograms) on the same
numpy inputs: extra_trees, by-node sampling, monotone constraints (basic
and intermediate, with the split penalty), interaction constraints,
``feature_contri`` and forced splits, alone and combined with quantized
gradients, bagging, EFB and a 3-class softmax.

Predictions on the TRAINING rows agree at rtol 1e-4 / atol 1e-5 (the bar
of ``tests/test_torch_train.py``, which says why validation rows are not
held to it), and every tree splits on the same features, its thresholds
equal up to bins that hold none of the node's training rows. The random
options (extra_trees' thresholds, by-node masks) draw the JAX package's
threefry streams bit for bit, so the same seeds pick the same candidates.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import json

import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
ROUNDS = 5


def _fused_data(n=1200, d=8, seed=11):
    """tests/test_fused.py's data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X[:, 1] + np.sin(X[:, 2] * 2) + X[:, 3] * 0.5
         + 0.1 * rng.randn(n))
    return X, y


def _discrete_data(seed=1, n=1500, d=8, levels=8):
    """Few-valued features, so no bin of a leaf holds only out-of-bag rows
    (tests/test_torch_train.py:_discrete_data)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, levels, (n, d)).astype(np.float64)
    z = X[:, 0] - 0.5 * X[:, 1] + np.sin(X[:, 2]) + 0.3 * rng.randn(n)
    return X, z


def _node_rows(tree, binned):
    rows = {0: np.arange(binned.shape[0])}
    for k in range(tree.num_leaves - 1):
        r = rows[k]
        go = binned[r, tree.split_feature_inner[k]] <= tree.threshold_bin[k]
        for child, side in ((tree.left_child[k], r[go]),
                            (tree.right_child[k], r[~go])):
            if child >= 0:
                rows[child] = side
    return rows


def _assert_same_splits(tj, tt, binned):
    """tests/test_torch_train.py's tie rule: the same split feature at
    every node, thresholds equal up to bins that hold none of the node's
    training rows."""
    assert tt.split_feature == tj.split_feature
    rows = _node_rows(tj, binned)
    for k in range(tj.num_leaves - 1):
        lo, hi = sorted((tj.threshold_bin[k], tt.threshold_bin[k]))
        b = binned[rows[k], tj.split_feature_inner[k]]
        assert not np.any((b > lo) & (b <= hi)), (k, lo, hi)


def _both(params, X, y, rounds=ROUNDS, splits=True, cat="auto"):
    bj = lgb.train({**params, **JAX_F32},
                   lgb.Dataset(X, label=y, categorical_feature=cat), rounds)
    dt = lgt.Dataset(X, label=y, categorical_feature=cat)
    bt = lgt.train({**params, **CPU}, dt, rounds)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    tj, tt = bj._booster.host_models, bt._booster.host_models
    assert [t.num_leaves for t in tt] == [t.num_leaves for t in tj]
    if splits:
        binned = dt.construct().binned
        for a, b in zip(tj, tt):
            if not any(a.is_categorical):
                _assert_same_splits(a, b, binned)
    return bj, bt


BASE = {"objective": "regression", "num_leaves": 15,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1}
MONO = [1, -1, 1, 0, -1, 0, 0, 0]


@pytest.mark.parametrize("extra", [
    {"extra_trees": True, "extra_seed": 13},
    {"feature_fraction_bynode": 0.5, "feature_fraction": 0.8,
     "feature_fraction_seed": 5},
    {"monotone_constraints": MONO, "monotone_penalty": 1.0},
    {"monotone_constraints": MONO,
     "monotone_constraints_method": "intermediate"},
    {"interaction_constraints": [[0, 1, 2], [2, 3, 4], [5, 6]]},
    {"feature_contri": [1.0, 0.5, 1.0, 0.7, 1.0, 1.0, 0.3, 1.0]},
    {"extra_trees": True, "feature_fraction_bynode": 0.5,
     "interaction_constraints": [[0, 1, 2, 3], [3, 4, 5]],
     "monotone_constraints": MONO,
     "monotone_constraints_method": "intermediate", "monotone_penalty": 2.0,
     "feature_contri": [1.0, 0.8, 1.0, 1.0, 0.6, 1.0, 1.0, 1.0]},
], ids=["extra_trees", "bynode", "monotone_basic_penalty",
        "monotone_intermediate", "interaction", "feature_contri", "all"])
def test_option_matches_jax(extra):
    X, y = _fused_data()
    _both({**BASE, **extra}, X, y)


def test_options_with_a_categorical_feature_match_jax():
    """extra_trees' one candidate and the monotone clamp in the categorical
    one-vs-rest scan (a 12-category column beside constrained numerical
    ones). Sorted-subset splits are held at the scan
    (tests/test_torch_split.py): a subset and its complement tie, either
    side may take it, and under extra_trees the side picks the key."""
    X, y = _fused_data()
    X[:, 0] = np.random.RandomState(5).randint(0, 12, len(X))
    y = y + (X[:, 0] % 3) * 0.5
    params = {**BASE, "extra_trees": True, "max_cat_to_onehot": 16,
              "monotone_constraints": [0] + MONO[1:],
              "monotone_constraints_method": "intermediate"}
    _, bt = _both(params, X, y, cat=[0])
    assert any(any(t.is_categorical) for t in bt._booster.host_models)


def test_monotone_models_are_monotone():
    """Both methods' predictions are monotone along each constrained
    feature (the property the option exists for)."""
    X, y = _fused_data()
    grid = np.linspace(-3, 3, 64)
    for method in ("basic", "intermediate"):
        bt = lgt.train({**BASE, **CPU, "monotone_constraints": MONO,
                        "monotone_constraints_method": method},
                       lgt.Dataset(X, label=y), ROUNDS)
        for f, sign in ((0, 1), (1, -1), (2, 1), (4, -1)):
            rows = np.repeat(X[:20], len(grid), axis=0)
            rows[:, f] = np.tile(grid, 20)
            d = np.diff(bt.predict(rows).reshape(20, -1), axis=1)
            assert (d * sign >= -1e-12).all(), (method, f)


def _forced(tmp_path, node) -> str:
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(node))
    return str(path)


def test_forced_splits_match_jax(tmp_path):
    """A three-level forced tree on a noise feature: every tree starts with
    it, as in the JAX package."""
    X, y = _fused_data()
    node = {"feature": 7, "threshold": 0.1,
            "left": {"feature": 6, "threshold": -0.2,
                     "left": {"feature": 5, "threshold": 0.0}},
            "right": {"feature": 0, "threshold": 0.3}}
    bj, bt = _both({**BASE, "forcedsplits_filename": _forced(tmp_path, node)},
                   X, y)
    for tree in bt._booster.host_models:
        assert tree.split_feature[:4] == [7, 6, 0, 5]


def test_an_invalid_forced_split_aborts_and_the_step_takes_the_argmax(
        tmp_path):
    """The second forced split leaves one side empty: forcing aborts and
    that same step takes the best split, as in the JAX package."""
    X, y = _fused_data()
    node = {"feature": 1, "threshold": 0.0,
            "left": {"feature": 2, "threshold": 50.0}}
    bj, bt = _both({**BASE, "forcedsplits_filename": _forced(tmp_path, node)},
                   X, y)
    for tree in bt._booster.host_models:
        assert tree.split_feature[0] == 1 and tree.num_leaves == 15


def test_forced_split_under_efb_matches_jax(tmp_path):
    """Forced splits on a bundle-forming table: the forced leaf's
    histogram is un-bundled before the fixed split is gathered."""
    rng = np.random.RandomState(17)
    which = rng.randint(0, 6, 2000)
    X = np.zeros((2000, 6))
    X[np.arange(2000), which] = rng.rand(2000) + 0.5
    y = X.sum(1) * (1 + which % 3) + rng.randn(2000) * 0.1
    node = {"feature": 2, "threshold": 0.9,
            "left": {"feature": 4, "threshold": 0.7}}
    bj, bt = _both({**BASE, "forcedsplits_filename": _forced(tmp_path, node)},
                   X, y, splits=False)
    assert bt._booster.learner.x_rows.shape[1] < 6
    for tree in bt._booster.host_models:
        assert tree.split_feature[:2] == [2, 4]


def test_quantized_bagged_intermediate_bynode_matches_jax():
    """(d)+(b) under 16-level quantized gradients and bagging 0.7/1: the
    options ride the K2 path as the JAX program allows."""
    X, z = _discrete_data()
    params = {**BASE, "use_quantized_grad": True, "num_grad_quant_bins": 16,
              "bagging_fraction": 0.7, "bagging_freq": 1,
              "monotone_constraints": MONO,
              "monotone_constraints_method": "intermediate",
              "feature_fraction_bynode": 0.5}
    _, bt = _both(params, X, z)
    assert bt._booster.learner.quant


def test_softmax_extra_trees_bynode_matches_jax():
    """3-class softmax with extra_trees and by-node sampling: the keys are
    split once a tree, class trees included, in the JAX program's order."""
    X, y = _fused_data()
    cls = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3]))
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "extra_trees": True, "feature_fraction_bynode": 0.6}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=cls), 4)
    dt = lgt.Dataset(X, label=cls)
    bt = lgt.train({**params, **CPU}, dt, 4)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)
    binned = dt.construct().binned
    for a, b in zip(bj._booster.host_models, bt._booster.host_models):
        _assert_same_splits(a, b, binned)


def test_monotone_on_a_categorical_feature_is_fatal():
    X, y = _fused_data()
    X[:, 0] = np.random.RandomState(0).randint(0, 5, len(X))
    with pytest.raises(RuntimeError, match="categorical"):
        lgt.train({**BASE, **CPU, "monotone_constraints": [1] + [0] * 7},
                  lgt.Dataset(X, label=y, categorical_feature=[0]), 2)
