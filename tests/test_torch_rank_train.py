"""Ranking end to end on the CPU: the port's ``lgt.train`` with
``lambdarank`` / ``rank_xendcg`` held to the JAX package's fused learner
(``JAX_F32``: the JAX ``auto`` learner is the serial one on a CPU) on
``tests/test_rank.py``'s query sets.

Predictions on the training rows are held at rtol 1e-4 / atol 1e-5 (the
bar of ``tests/test_torch_train.py``); the validation sets here are the
training rows again, so their ``ndcg@k`` histories (with early stopping,
greater is better) must match in length and within 1e-6.
"""
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from test_rank import _make_ltr

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
BASE = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [3, 5],
        "num_leaves": 15, "min_data_in_leaf": 5, "learning_rate": 0.1,
        "verbose": -1}


def _train_both(params, X, y, group, position=None, rounds=10):
    """(JAX booster, port booster, JAX history, port history): each trained
    with the training rows as a validation set and early_stopping(3)."""
    out = []
    for pkg, extra in ((lgb, JAX_F32), (lgt, CPU)):
        ds = pkg.Dataset(X, label=y, group=group, position=position)
        res = {}
        b = pkg.train({**params, **extra}, ds, rounds,
                      valid_sets=[ds.create_valid(X, label=y, group=group,
                                                  position=position)],
                      callbacks=[pkg.record_evaluation(res),
                                 pkg.early_stopping(3, verbose=False)])
        out.append((b, res["valid_0"]))
    (bj, hj), (bt, ht) = out
    return bj, bt, hj, ht


def _assert_same_model(bj, bt, hj, ht, X):
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]
    assert sorted(ht) == sorted(hj)
    for name in hj:
        assert len(ht[name]) == len(hj[name]), name
        np.testing.assert_allclose(ht[name], hj[name], rtol=0, atol=1e-6)
    assert bt.best_iteration == bj.best_iteration


@pytest.mark.parametrize("extra", [
    {"lambdarank_target": "ndcg"},
    {"lambdarank_target": "lambdagap-s"},
    {"lambdarank_target": "lambdagap-x-plus-plus", "lambdagap_weight": 0.5},
    {"lambdarank_target": "arpk"},
    {"lambdarank_target": "lambdaloss-ndcg-plus-plus",
     "lambdagap_weight": 0.5},
    {"objective": "rank_xendcg"},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "bagging_by_query": True},
    {"use_quantized_grad": True, "num_grad_quant_bins": 16},
])
def test_ranking_training_matches_jax(extra):
    X, y, group = _make_ltr(seed=1)
    bj, bt, hj, ht = _train_both({**BASE, **extra}, X, y, group)
    _assert_same_model(bj, bt, hj, ht, X)


def test_position_bias_training_matches_jax():
    """``position=``: the trees at the training-row bar and the
    position-bias vector after 10 rounds at rtol 1e-5."""
    X, y, group = _make_ltr(seed=6)
    pos = np.tile(np.arange(25), 60)
    bj, bt, hj, ht = _train_both(BASE, X, y, group, position=pos)
    _assert_same_model(bj, bt, hj, ht, X)
    pj = np.asarray(bj._booster.objective.pos_biases)
    pt = bt._booster.objective.pos_biases.numpy()
    assert pt.shape == (25,) and np.abs(pt).sum() > 0
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-8)


def test_rank_metrics_reported_under_jax_names():
    """ndcg / map / precision at each eval_at, as record_evaluation and
    best_score carry them."""
    X, y, group = _make_ltr(seed=8)
    params = {**BASE, "metric": ["ndcg", "map", "precision"],
              "eval_at": [1, 3, 5]}
    bj, bt, hj, ht = _train_both(params, X, y, group, rounds=6)
    assert sorted(ht) == sorted(f"{m}@{k}" for m in ("ndcg", "map",
                                                     "precision")
                                for k in (1, 3, 5))
    _assert_same_model(bj, bt, hj, ht, X)
    assert sorted(bt.best_score["valid_0"]) == sorted(ht)
