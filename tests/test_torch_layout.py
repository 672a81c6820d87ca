"""``tree_layout=sorted`` in the port, on the CPU.

* Sorted equals gather bit for bit: the model text of the two layouts is
  byte-equal but for the ``[tree_layout: ...]`` parameter line, in both
  learners, under every option the layout carries (f32 and quantized
  gradients, bagging, GOSS, EFB, categorical features, softmax, lambdarank,
  the tree options, CEGB and advanced monotone, the L1 leaf renewal, u16
  bins). The port's histograms are exact integer sums of the same rows,
  so this bar is stricter than the JAX package's own sorted-vs-gather one.
* The port's sorted models against the JAX package's sorted models
  (``tests/test_layout.py:37-47``'s runs, one-hot histograms in f32):
  predictions on the training rows within rtol 1e-4 / atol 1e-5.
* ``auto`` resolves as the JAX resolver does, on either side of 2^20 rows
  (the resolvers are called on a stand-in learner, no million-row data).
* Under sorted no column-major copy is held, and the leaf-ordered copies
  after a tree are the rows in the order of its final permutation.
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
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.models.learner import SerialTreeLearner as JaxSerial
from lambdagap_tpu_torch.models.learner import SerialTreeLearner
from lambdagap_tpu_torch.ops.partition import GatherRows, SortedRows

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_hist_impl": "onehot", "tpu_hist_precision": "f32"}
BASE = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 10,
        "learning_rate": 0.1, "verbose": -1}
ROUNDS = 4


def _data(n=900, d=8, seed=11, cat=False):
    """tests/test_layout.py's data: 900 rows never tile a kernel's blocks,
    so leaves are ragged."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    if cat:
        X[:, 0] = rng.randint(0, 9, n)
    y = (X[:, 1] + np.sin(X[:, 2] * 2)
         + ((X[:, 0] % 3) if cat else X[:, 3]) * 0.5 + 0.1 * rng.randn(n))
    return X, y


def _efb_data(n=1500, seed=17):
    """Six one-hot-like columns EFB bundles, beside two dense ones."""
    rng = np.random.RandomState(seed)
    which = rng.randint(0, 6, n)
    X = np.zeros((n, 8))
    X[np.arange(n), which] = rng.rand(n) + 0.5
    X[:, 6:] = rng.randn(n, 2)
    y = X[:, :6].sum(1) * (1 + which % 3) + X[:, 6] + rng.randn(n) * 0.1
    return X, y


def _rank_data(queries=60, docs=20, d=8, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(queries * docs, d)
    score = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(len(X))
    rel = np.clip(np.round(score + 1.5), 0, 4)
    return X, rel, np.full(queries, docs)


def _text(bst) -> str:
    """The model text without the layout's own parameter line."""
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("[tree_layout:"))


def _train(layout, params, X, y, rounds=ROUNDS, cat=None, group=None):
    p = {**params, **CPU, "tree_layout": layout}
    ds = lgt.Dataset(X, label=y, group=group,
                     categorical_feature=cat if cat else "auto")
    bst = lgt.train(p, ds, rounds)
    assert bst._booster.learner.layout == layout
    return bst


def _forced(tmp_path) -> str:
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 7, "threshold": 0.1,
                                "left": {"feature": 6, "threshold": -0.2}}))
    return str(path)


CASES = {
    "f32": {},
    "max_depth_l1_l2": {"max_depth": 3, "lambda_l1": 0.5, "lambda_l2": 2.0},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.5},
    "quantized_sr": {"use_quantized_grad": True, "num_grad_quant_bins": 4,
                     "stochastic_rounding": True},
    "quantized_round_renew_bagged": {
        "use_quantized_grad": True, "num_grad_quant_bins": 16,
        "stochastic_rounding": False, "quant_train_renew_leaf": True,
        "bagging_fraction": 0.7, "bagging_freq": 1},
    "u16_bins": {"max_bin": 300, "min_data_in_bin": 1},
    "l1_renew": {"objective": "regression_l1"},
    "serial": {"tpu_fused_learner": "0"},
    "serial_bagging_u16": {"tpu_fused_learner": "0", "max_bin": 300,
                           "min_data_in_bin": 1, "bagging_fraction": 0.7,
                           "bagging_freq": 1},
    "serial_lazy_cegb_advanced": {
        "tpu_fused_learner": "0", "cegb_tradeoff": 1.0,
        "cegb_penalty_feature_lazy": [0.01 * (1 + j % 3) for j in range(8)],
        "monotone_constraints": [1, -1, 1, 0, 0, 0, 0, 0],
        "monotone_constraints_method": "advanced",
        "bagging_fraction": 0.8, "bagging_freq": 1},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sorted_equals_gather(name):
    X, y = _data()
    rounds = 6 if name == "goss" else ROUNDS
    params = {**BASE, **CASES[name]}
    bg = _train("gather", params, X, y, rounds)
    bs = _train("sorted", params, X, y, rounds)
    assert bs._booster.serial == ("tpu_fused_learner" in CASES[name])
    assert _text(bs) == _text(bg)
    if name.startswith("u16") or name.endswith("u16"):
        assert bs._booster.learner.x_rows.dtype == torch.uint16


def test_sorted_equals_gather_categorical():
    X, y = _data(cat=True)
    bg = _train("gather", BASE, X, y, cat=[0])
    bs = _train("sorted", BASE, X, y, cat=[0])
    assert any(any(t.is_categorical) for t in bs._booster.host_models)
    assert _text(bs) == _text(bg)


@pytest.mark.parametrize("serial", [False, True])
def test_sorted_equals_gather_efb(serial):
    X, y = _efb_data()
    params = {**BASE, "bagging_fraction": 0.8, "bagging_freq": 1,
              **({"tpu_fused_learner": "0"} if serial else {})}
    bg = _train("gather", params, X, y)
    bs = _train("sorted", params, X, y)
    lr = bs._booster.learner
    # the fused learner reads the bundled columns, the serial one per-feature
    assert (lr.x_rows.shape[1] < 8) != serial
    assert _text(bs) == _text(bg)


def test_sorted_equals_gather_softmax():
    X, y = _data(seed=3)
    cls = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    bg = _train("gather", params, X, cls)
    bs = _train("sorted", params, X, cls)
    assert len(bs._booster.models) == 3 * ROUNDS
    assert _text(bs) == _text(bg)


def test_sorted_equals_gather_lambdarank():
    X, rel, group = _rank_data()
    params = {**BASE, "objective": "lambdarank", "metric": "ndcg",
              "bagging_by_query": True, "bagging_fraction": 0.7,
              "bagging_freq": 1}
    bg = _train("gather", params, X, rel, group=group)
    bs = _train("sorted", params, X, rel, group=group)
    assert _text(bs) == _text(bg)


def test_sorted_equals_gather_tree_options(tmp_path):
    """extra_trees, a forced split and intermediate monotone together."""
    X, y = _data()
    params = {**BASE, "extra_trees": True, "extra_seed": 4,
              "forcedsplits_filename": _forced(tmp_path),
              "monotone_constraints": [1, -1, 1, 0, 0, 0, 0, 0],
              "monotone_constraints_method": "intermediate"}
    bg = _train("gather", params, X, y)
    bs = _train("sorted", params, X, y)
    for tree in bs._booster.host_models:
        assert tree.split_feature[:2] == [7, 6]
    assert _text(bs) == _text(bg)


@pytest.mark.parametrize("extra", [
    {"tpu_fused_learner": "1"},
    {"tpu_fused_learner": "1", "use_quantized_grad": True,
     "num_grad_quant_bins": 16, "stochastic_rounding": True},
    {"tpu_fused_learner": "0"},
])
def test_sorted_matches_jax_sorted(extra):
    """The port's sorted model against the JAX package's sorted model
    (``tests/test_layout.py:37-47``'s run) on the training rows."""
    X, y = _data()
    params = {**BASE, **extra, "tree_layout": "sorted"}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), ROUNDS)
    assert bj._booster.learner.layout == "sorted"
    bt = _train("sorted", params, X, y)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert ([t.num_leaves for t in bt._booster.host_models]
            == [t.num_leaves for t in bj._booster.host_models])


@pytest.mark.parametrize("layout", ["auto", "gather", "sorted"])
@pytest.mark.parametrize("rows", [(1 << 20) - 1, 1 << 20])
@pytest.mark.parametrize("supported", [True, False])
def test_layout_resolves_as_jax(layout, rows, supported, caplog):
    """``auto`` is sorted iff rows >= 2^20 and the learner supports it; a
    learner that opts out keeps gather and logs the reference's line."""
    learner = types.SimpleNamespace(num_data=rows,
                                    supports_sorted_layout=supported)
    want = JaxSerial._resolve_layout(
        learner, JaxConfig.from_params({"tree_layout": layout}))
    with caplog.at_level(logging.INFO):
        got = SerialTreeLearner._resolve_layout(
            learner, lgt.Config.from_params({"tree_layout": layout}))
    assert got == want
    assert got == ("sorted" if supported and (
        layout == "sorted" or (layout == "auto" and rows >= 1 << 20))
        else "gather")
    if not supported and layout == "sorted":
        assert "not supported" in caplog.text
    assert SerialTreeLearner.supports_sorted_layout


@pytest.mark.parametrize("serial", [False, True])
def test_sorted_holds_no_column_copy(serial):
    """No x_cols under sorted (JAX fused_learner.py:233-245): the resident
    count holds the rows, their leaf-ordered copy and its scratch instead
    of the rows and their column-major copy."""
    X, y = _data()
    params = {**BASE, "tpu_fused_learner": "0" if serial else "1"}
    lg = _train("gather", params, X, y, rounds=1)._booster.learner
    ls = _train("sorted", params, X, y, rounds=1)._booster.learner
    assert isinstance(ls.row_layout, SortedRows)
    assert not hasattr(ls.row_layout, "x_cols")
    assert isinstance(lg.row_layout, GatherRows)
    x_bytes = ls.x_rows.numel() * ls.x_rows.element_size()
    assert lg.resident_bytes() == 2 * x_bytes
    assert ls.resident_bytes() == ls.row_layout.nbytes() + x_bytes
    assert ls.row_layout.nbytes() >= 2 * x_bytes


def test_sorted_copies_follow_the_final_permutation():
    """After a tree the leaf-ordered copies are the rows, grad, hess and
    the in-bag mask in the order of the tree's final permutation: each
    leaf a contiguous window of its own rows."""
    X, y = _data()
    params = {**BASE, "tpu_fused_learner": "0", "bagging_fraction": 0.7,
              "bagging_freq": 1}
    gb = _train("sorted", params, X, y, rounds=1)._booster
    lr = gb.learner
    grad, hess = gb.boosting()
    mask = torch.from_numpy(np.random.RandomState(2).rand(len(y)) < 0.7)
    lr.train(grad[0], hess[0], mask)
    perm = lr.last_perm.long()
    sr = lr.row_layout
    assert torch.equal(sr.x, lr.x_rows[perm])
    assert torch.equal(sr.ch[0], grad[0][perm])
    assert torch.equal(sr.ch[1], hess[0][perm])
    assert torch.equal(sr.mask, mask[perm])
    for b, c in zip(lr.last_leaf_begin, lr.last_leaf_count):
        leaf = lr.last_row_leaf[perm[b:b + c]]
        assert bool((leaf == leaf[0]).all())
