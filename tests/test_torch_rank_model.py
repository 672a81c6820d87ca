"""Ranker models in the port on the CPU: each of the 18
``lambdarank_target``s trains to ``tests/test_rank.py``'s bar, rank_xendcg
learns and ``lambdagap_weight`` matters, and a ranker the JAX package
trained loads, saves and serves in the port (its text raised before the
ranking objectives were ported)."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.config import LAMBDARANK_TARGETS
from lambdagap_tpu.serve.delta import split_model_text as jax_split
from lambdagap_tpu_torch.serve.delta import split_model_text
from test_rank import _make_ltr, _ndcg_at

CPU = {"device_type": "cpu"}
BASE = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [3, 5],
        "num_leaves": 15, "min_data_in_leaf": 5, "learning_rate": 0.1,
        "verbose": -1}


@pytest.mark.parametrize("target", LAMBDARANK_TARGETS)
def test_every_target_trains_on_the_cpu(target):
    """tests/test_rank.py's bar for each of the 18 targets, in the port."""
    X, labels, group = _make_ltr(n_queries=30, docs_per_query=15, seed=2)
    booster = lgt.train({"objective": "lambdarank",
                         "lambdarank_target": target,
                         "lambdarank_truncation_level": 5,
                         "num_leaves": 7, "verbose": -1,
                         "min_data_in_leaf": 3, **CPU},
                        lgt.Dataset(X, label=labels, group=group),
                        num_boost_round=15)
    assert booster.num_trees() == 15
    assert _ndcg_at(booster, X, labels, group) > 0.6


def test_rank_xendcg_learns_and_lambdagap_weight_matters():
    X, labels, group = _make_ltr(seed=4)
    b = lgt.train({"objective": "rank_xendcg", "verbose": -1,
                   "min_data_in_leaf": 5, "num_leaves": 15, **CPU},
                  lgt.Dataset(X, label=labels, group=group), 40)
    assert _ndcg_at(b, X, labels, group) > 0.8
    preds = [lgt.train({"objective": "lambdarank",
                        "lambdarank_target": "lambdaloss-ndcg-plus-plus",
                        "lambdagap_weight": w, "verbose": -1,
                        "min_data_in_leaf": 5, **CPU},
                       lgt.Dataset(X, label=labels, group=group),
                       10).predict(X, raw_score=True) for w in (0.1, 5.0)]
    assert not np.allclose(preds[0], preds[1])


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_jax_trained_ranker_loads_serves_and_saves(objective, tmp_path):
    """A ranker's text from the JAX package loads in the port (it raised
    before the ranking objectives were ported), saves the same tree region
    byte for byte, round-trips byte-stably and serves the JAX compiled
    engine's raw scores exactly."""
    X, y, group = _make_ltr(seed=3)
    bj = lgb.train({**BASE, "objective": objective},
                   lgb.Dataset(X, label=y, group=group), 8)
    text = bj.model_to_string()
    port = lgt.Booster(model_str=text, params=CPU)
    assert port._booster.objective.name == objective
    assert port._booster.objective_string() == \
        lgb.Booster(model_str=text)._booster.objective_string()
    _h, jax_blocks, _t = jax_split(text)
    _h2, port_blocks, _t2 = split_model_text(port.model_to_string())
    assert "".join(port_blocks) == "".join(jax_blocks)
    again = lgt.Booster(model_str=port.model_to_string(), params=CPU)
    assert again.model_to_string() == port.model_to_string()
    path = tmp_path / "m.txt"
    port.save_model(str(path))
    assert lgt.Booster(model_file=str(path),
                       params=CPU).model_to_string() == \
        port.model_to_string()
    ref = lgb.Booster(model_str=text, params={"predict_engine": "compiled",
                                              "tpu_fast_predict_rows": 0})
    want = np.asarray(ref.predict(X, raw_score=True), np.float32)
    with port.as_server(raw_score=True) as server:
        got = server.predict(X.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    np.testing.assert_array_equal(port.predict(X), port.predict(
        X, raw_score=True))                # rankers convert as identity
