"""The host-driven SerialTreeLearner (``tpu_fused_learner=0``) on the CPU,
held to the JAX package's serial learner on the same numpy inputs: the
objectives, sampling, every tree option on the serial learner's numpy
streams, CEGB (split, coupled, lazy), advanced monotone constraints, EFB
tables, the non-finite guard and the learner routing.

The JAX side runs its one-hot histograms in full f32 (``JAX_SERIAL``).
Predictions on the TRAINING rows agree at rtol 1e-4 / atol 1e-5, the trees
have the same leaf counts, and every tree without a categorical split
splits on the same features with thresholds equal up to bins that hold
none of the node's training rows (``tests/test_torch_tree_options.py``'s
rule; ``tests/test_torch_train.py`` says why validation rows are not held
to that bar). The advanced method's dense bounds, built on the device for
a batch of leaves, are held ``torch.equal`` to the JAX package's host
function on the same boxes.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import json
import logging
import types

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.guard.nonfinite import NonFiniteError as JaxNonFinite
from lambdagap_tpu.models.learner import SerialTreeLearner as JaxSerial
from lambdagap_tpu_torch.guard.nonfinite import NonFiniteError
from lambdagap_tpu_torch.models.learner import (SerialTreeLearner,
                                                advanced_bound_arrays)

CPU = {"device_type": "cpu", "tpu_fused_learner": "0"}
JAX_SERIAL = {"tpu_fused_learner": "0", "tpu_hist_impl": "onehot",
              "tpu_hist_precision": "f32"}
ROUNDS = 5
BASE = {"objective": "regression", "num_leaves": 15,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1}
MONO = [1, -1, 1, 0, -1, 0, 0, 0]


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


def _onehot_data():
    """A one-hot-like table on which EFB forms a bundle
    (tests/test_torch_train.py:test_a_formed_bundle_trains_like_jax)."""
    rng = np.random.RandomState(17)
    which = rng.randint(0, 6, 2000)
    X = np.zeros((2000, 6))
    X[np.arange(2000), which] = rng.rand(2000) + 0.5
    return X, X.sum(1) * (1 + which % 3) + rng.randn(2000) * 0.1


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
    assert tt.split_feature == tj.split_feature
    rows = _node_rows(tj, binned)
    for k in range(tj.num_leaves - 1):
        lo, hi = sorted((tj.threshold_bin[k], tt.threshold_bin[k]))
        b = binned[rows[k], tj.split_feature_inner[k]]
        assert not np.any((b > lo) & (b <= hi)), (k, lo, hi)


def _both(params, X, y, rounds=ROUNDS, cat="auto"):
    bj = lgb.train({**params, **JAX_SERIAL},
                   lgb.Dataset(X, label=y, categorical_feature=cat), rounds)
    dt = lgt.Dataset(X, label=y, categorical_feature=cat)
    bt = lgt.train({**params, **CPU}, dt, rounds)
    assert isinstance(bt._booster.learner, SerialTreeLearner)
    assert bt._booster.serial
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)
    tj, tt = bj._booster.host_models, bt._booster.host_models
    assert [t.num_leaves for t in tt] == [t.num_leaves for t in tj]
    binned = dt.construct().binned
    for a, b in zip(tj, tt):
        if not any(a.is_categorical):
            _assert_same_splits(a, b, binned)
    return bj, bt


def _labels(objective, y):
    if objective == "binary":
        return (y > np.median(y)).astype(float)
    if objective == "multiclass":
        return np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    return y


@pytest.mark.parametrize("extra", [
    {},
    {"objective": "binary"},
    {"objective": "multiclass", "num_class": 3},
    {"objective": "regression_l1"},
    {"max_depth": 3, "lambda_l1": 0.5, "lambda_l2": 2.0},
], ids=["regression", "binary", "softmax", "l1_refit", "depth_l1_l2"])
def test_objective_matches_jax_serial(extra):
    X, y = _fused_data()
    bj, bt = _both({**BASE, **extra}, X, _labels(extra.get("objective"), y))
    if extra.get("objective") == "regression_l1":
        assert bt._booster.renew_ms


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"data_sample_strategy": "goss", "learning_rate": 0.3},
], ids=["bagging", "goss"])
def test_sampling_matches_jax_serial(extra):
    X, z = _discrete_data()
    _both({**BASE, **extra}, X, z, rounds=6)


@pytest.mark.parametrize("extra", [
    {"extra_trees": True, "extra_seed": 13},
    {"feature_fraction_bynode": 0.5, "feature_fraction": 0.8,
     "feature_fraction_seed": 5},
    {"monotone_constraints": MONO, "monotone_penalty": 1.0},
    {"monotone_constraints": MONO, "monotone_penalty": 2.0,
     "monotone_constraints_method": "intermediate"},
    {"interaction_constraints": [[0, 1, 2], [2, 3, 4], [5, 6]]},
    {"feature_contri": [1.0, 0.5, 1.0, 0.7, 1.0, 1.0, 0.3, 1.0]},
    {"extra_trees": True, "feature_fraction_bynode": 0.5,
     "interaction_constraints": [[0, 1, 2, 3], [3, 4, 5]],
     "monotone_constraints": MONO,
     "monotone_constraints_method": "intermediate", "monotone_penalty": 2.0,
     "feature_contri": [1.0, 0.8, 1.0, 1.0, 0.6, 1.0, 1.0, 1.0]},
], ids=["extra_trees", "bynode", "monotone_basic_penalty",
        "monotone_intermediate_penalty", "interaction", "feature_contri",
        "all"])
def test_option_matches_jax_serial(extra):
    """The options draw the serial learner's numpy streams (by-node off
    feature_fraction_seed, extra_trees' F ints a scan off extra_seed, the
    smaller child first), so the same seeds pick the same candidates."""
    X, y = _fused_data()
    _both({**BASE, **extra}, X, y)


def test_forced_splits_match_jax_serial(tmp_path):
    X, y = _fused_data()
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({
        "feature": 7, "threshold": 0.1,
        "left": {"feature": 6, "threshold": -0.2,
                 "left": {"feature": 5, "threshold": 0.0}},
        "right": {"feature": 0, "threshold": 0.3}}))
    _, bt = _both({**BASE, "forcedsplits_filename": str(path)}, X, y)
    for tree in bt._booster.host_models:
        assert tree.split_feature[:4] == [7, 6, 0, 5]


LAZY = [0.01, 0.02, 0.05, 0.0, 0.01, 0.03, 0.02, 0.01]


@pytest.mark.parametrize("extra", [
    {"cegb_penalty_split": 0.002},
    {"cegb_penalty_feature_coupled": [5, 1, 10, 2, 0, 0, 3, 3]},
    {"cegb_tradeoff": 0.5, "cegb_penalty_feature_lazy": LAZY},
    {"cegb_penalty_feature_lazy": LAZY, "bagging_fraction": 0.8,
     "bagging_freq": 1, "_discrete": True},
    {"cegb_penalty_split": 0.001, "cegb_penalty_feature_lazy": LAZY,
     "cegb_penalty_feature_coupled": [5, 1, 10, 2, 0, 0, 3, 3],
     "monotone_constraints": MONO,
     "monotone_constraints_method": "intermediate"},
], ids=["split", "coupled", "lazy", "lazy_bagged", "all_intermediate"])
def test_cegb_matches_jax_serial(extra):
    """CEGB's three penalties; the coupled cost is paid once a model and
    the lazy cost once a row, so later trees see what earlier ones paid."""
    extra = dict(extra)
    X, y = _discrete_data() if extra.pop("_discrete", False) \
        else _fused_data()
    _, bt = _both({**BASE, **extra}, X, y)
    lr = bt._booster.learner
    assert lr.cegb_on
    if "cegb_penalty_feature_lazy" in extra:
        assert lr._paid.any()


def test_cegb_uses_fewer_features():
    """The coupled penalty on every feature keeps a model on fewer
    distinct features than the same run without it."""
    X, y = _fused_data()

    def used(params):
        bst = lgt.train({**BASE, **CPU, **params}, lgt.Dataset(X, label=y),
                        ROUNDS)
        return {f for t in bst._booster.host_models
                for f in t.split_feature}

    assert len(used({"cegb_penalty_feature_coupled": [40.0] * 8})) < \
        len(used({}))


@pytest.mark.parametrize("extra", [
    {},
    {"monotone_penalty": 1.0, "extra_trees": True},
    {"feature_fraction_bynode": 0.6, "bagging_fraction": 0.8,
     "bagging_freq": 1, "_discrete": True},
], ids=["plain", "penalty_extra_trees", "bynode_bagged"])
def test_advanced_monotone_matches_jax_serial(extra):
    """The advanced method's per-threshold bounds and its re-scans of the
    leaves each split's old box constrained."""
    extra = dict(extra)
    X, y = _discrete_data() if extra.pop("_discrete", False) \
        else _fused_data()
    _, bt = _both({**BASE, "monotone_constraints": MONO,
                   "monotone_constraints_method": "advanced", **extra}, X, y)
    grid = np.linspace(X.min(), X.max(), 48)
    for f, sign in ((0, 1), (1, -1), (2, 1), (4, -1)):
        rows = np.repeat(X[:16], len(grid), axis=0)
        rows[:, f] = np.tile(grid, 16)
        d = np.diff(bt.predict(rows, raw_score=True).reshape(16, -1), axis=1)
        assert (d * sign >= 0).all(), f


def test_advanced_monotone_with_a_categorical_feature_matches_jax_serial():
    """A 12-category column beside advanced-constrained numerical ones:
    a categorical split keeps its parent's box for both children and
    clamps both to the full-range bound."""
    X, y = _fused_data()
    X[:, 0] = np.random.RandomState(5).randint(0, 12, len(X))
    y = y + (X[:, 0] % 3) * 0.5
    _, bt = _both({**BASE, "max_cat_to_onehot": 16,
                   "monotone_constraints": [0] + MONO[1:],
                   "monotone_constraints_method": "advanced"}, X, y,
                  cat=[0])
    assert any(any(t.is_categorical) for t in bt._booster.host_models)


@pytest.mark.parametrize("extra", [{}, {"extra_trees": True}],
                         ids=["plain", "extra_trees"])
def test_efb_table_matches_jax_serial(extra):
    """The serial learner reads the per-feature matrix even where EFB
    forms a bundle (the JAX package's ``dataset.binned``)."""
    X, y = _onehot_data()
    _, bt = _both({"objective": "regression", "num_leaves": 15,
                   "verbose": -1, **extra}, X, y, rounds=6)
    ds = bt._booster.train_set
    assert ds.ensure_bundle(bt._booster.config) is not None
    assert bt._booster.learner.x_rows.shape[1] == 6


def _poisson_blowup():
    rng = np.random.RandomState(3)
    X = rng.randn(1000, 6)
    y = np.exp(X[:, 0] * 2 + X[:, 1]) * rng.poisson(1.0, 1000)
    return X, y, {"objective": "poisson", "num_leaves": 7,
                  "learning_rate": 2.9, "min_data_in_leaf": 5,
                  "verbose": -1}


def test_guard_raise_in_both_serial_learners():
    X, y, params = _poisson_blowup()
    with pytest.raises(JaxNonFinite):
        lgb.train({**params, **JAX_SERIAL}, lgb.Dataset(X, label=y), 4)
    with pytest.raises(NonFiniteError):
        lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 4)


def test_guard_skip_tree_matches_jax_serial():
    X, y, params = _poisson_blowup()
    params = {**params, "guard_nonfinite": "skip_tree"}
    bj = lgb.train({**params, **JAX_SERIAL}, lgb.Dataset(X, label=y), 5)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5)
    gj, gt = bj._booster, bt._booster
    assert len(gt.models) == len(gj.models)
    assert gt.iter_ == gj.iter_
    assert np.isfinite(gt.scores.numpy()).all()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("params, serial, message", [
    ({"cegb_penalty_split": 0.002}, True, "serial learner for: cegb"),
    ({"monotone_constraints": MONO,
      "monotone_constraints_method": "advanced"}, True,
     "monotone_constraints_method=advanced"),
    ({"tpu_fused_learner": "0", "use_quantized_grad": True}, True,
     "full precision"),
    ({"tpu_fused_learner": "1"}, False, None),
], ids=["cegb", "advanced", "quantized_on_serial", "fused"])
def test_learner_routing_warns(params, serial, message, caplog):
    """CEGB or advanced with the fused learner on go to the serial learner
    with a warning, as in the JAX package; quantized gradients on the
    serial learner warn and train in f32."""
    X, y = _fused_data(n=400)
    with caplog.at_level(logging.WARNING, logger="lambdagap_tpu_torch"):
        bst = lgt.train({"objective": "regression", "num_leaves": 7,
                         "verbose": 0, "device_type": "cpu", **params},
                        lgt.Dataset(X, label=y), 2)
    assert bst._booster.serial == serial
    warned = [r.getMessage() for r in caplog.records
              if r.levelno >= logging.WARNING]
    if message is None:
        assert not any("serial learner" in w for w in warned)
    else:
        assert any(message in w for w in warned), warned


def test_serial_counts_reads_and_histograms():
    """One read a split (the left count and both children's splits) plus
    the root's; one K1 histogram a split plus the root's, none after the
    last split."""
    X, y = _fused_data()
    bst = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 1)
    lr, tree = bst._booster.learner, bst._booster.host_models[0]
    assert tree.num_leaves == 15
    assert lr.host_syncs == tree.num_leaves
    assert lr.hist_builds == tree.num_leaves - 1


def _partition_boxes(rng, nb, n_leaves):
    """Bin-space boxes of a random tree: leaves split at random features
    and thresholds, so leaves lie across each other's boundaries."""
    F = len(nb)
    boxes = [(np.zeros(F, np.int64), nb.astype(np.int64).copy())]
    while len(boxes) < n_leaves:
        i = rng.randint(len(boxes))
        lo, hi = boxes[i]
        f = rng.randint(F)
        if hi[f] - lo[f] < 2:
            continue
        t = rng.randint(lo[f], hi[f] - 1)
        l_hi, r_lo = hi.copy(), lo.copy()
        l_hi[f] = r_lo[f] = t + 1
        boxes[i] = (lo, l_hi)
        boxes.append((r_lo, hi))
    return boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_bound_arrays_equal_jax_host_function(seed):
    """:func:`advanced_bound_arrays` on every leaf of a random partition at
    once == the JAX package's ``_advanced_bound_arrays`` leaf by leaf."""
    rng = np.random.RandomState(seed)
    F, B = 5, 16
    nb = rng.randint(6, B + 1, F)
    mono = np.array([1, 0, -1, 1, 0], np.int32)
    boxes = _partition_boxes(rng, nb, 23)
    values = rng.randn(len(boxes)).astype(np.float32)
    fake = types.SimpleNamespace(num_features=F, B=B, mono_np=mono)
    fake._adv_constrainers = types.MethodType(JaxSerial._adv_constrainers,
                                              fake)
    tree = types.SimpleNamespace(num_leaves=len(boxes),
                                 leaf_value=values.astype(np.float64))
    bx = {m: (lo.astype(np.int32), hi.astype(np.int32))
          for m, (lo, hi) in enumerate(boxes)}
    want = [JaxSerial._advanced_bound_arrays(fake, t, bx, tree)
            for t in range(len(boxes))]
    los = torch.from_numpy(np.stack([b[0] for b in boxes]))
    his = torch.from_numpy(np.stack([b[1] for b in boxes]))
    targets = np.arange(len(boxes))
    not_self = torch.from_numpy(targets[:, None] != targets[None, :])
    got = advanced_bound_arrays(los, his, los, his, torch.from_numpy(values),
                                not_self, mono, B)
    for i, name in enumerate(("min_l", "max_l", "min_r", "max_r")):
        expect = torch.from_numpy(np.stack([w[i] for w in want]))
        assert torch.equal(got[i], expect), name
    assert torch.isfinite(got[1]).any()     # some leaf is bounded


def test_booster_api_on_a_serial_model(tmp_path):
    """Every Booster method on a serially trained model: the text round
    trip, predict, pred_leaf (== the JAX serial model's on the training
    rows), pred_contrib (rows sum to the raw scores), refit,
    rollback_one_iter and dump_model."""
    X, y = _fused_data()
    bj, bt = _both({**BASE, "objective": "binary"}, X,
                   _labels("binary", y))
    raw = bt.predict(X, raw_score=True)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    path = tmp_path / "serial.txt"
    bt.save_model(str(path))
    loaded = lgt.Booster(model_file=str(path), params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True), raw)
    phi = bt.predict(X[:50], pred_contrib=True)
    np.testing.assert_allclose(phi.sum(1), raw[:50], rtol=1e-5, atol=1e-6)
    assert len(bt.dump_model()["tree_info"]) == ROUNDS
    kept = bt.refit(X, _labels("binary", y), decay_rate=1.0)
    np.testing.assert_allclose(kept.predict(X, raw_score=True), raw,
                               rtol=1e-6, atol=1e-6)
    bt._booster.rollback_one_iter()
    assert len(bt._booster.models) == ROUNDS - 1
    np.testing.assert_allclose(bt._booster.scores.numpy()[0],
                               bt.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True,
                                          num_iteration=ROUNDS - 1),
                               rtol=1e-4, atol=1e-5)
