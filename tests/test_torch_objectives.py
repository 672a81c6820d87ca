"""Objectives, metrics and the binned per-tree scoring of the training
slice, held to the JAX package on the same numpy inputs.

Gradients are f32 on both sides and are held at rtol 1e-6 (torch's exp and
XLA's differ in the last bit, and XLA may reassociate the constant
products); hessians at rtol 4e-6, because the binary hessian
``|r| * (sigmoid - |r|)`` subtracts two values of similar size when
sigmoid != 1, which magnifies that last bit; init scores are equal (the same numpy
arithmetic); metrics run the same float64 numpy code and are held at
rtol 1e-12; the binned traversal's leaf values are ``array_equal``.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data.dataset import Metadata as JaxMetadata
from lambdagap_tpu.metrics import create_metrics as jax_metrics
from lambdagap_tpu.objectives.base import create_objective as jax_objective
from lambdagap_tpu.ops.predict import predict_tree_binned as jax_ptb
from lambdagap_tpu.ops.predict import tree_to_arrays as jax_tta
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data.dataset import Metadata
from lambdagap_tpu_torch.metrics import create_metrics
from lambdagap_tpu_torch.objectives import create_objective
from lambdagap_tpu_torch.ops.predict import (predict_tree_binned, to_device,
                                             tree_to_arrays)

CPU = torch.device("cpu")


def _labels(kind, n=3000, seed=0):
    rng = np.random.RandomState(seed)
    y = ((rng.rand(n) < 0.3).astype(np.float32) if kind == "binary"
         else (rng.randn(n) * 3 + 1).astype(np.float32))
    w = (rng.rand(n) + 0.5).astype(np.float32)
    s = (rng.randn(1, n) * 2).astype(np.float32)
    return y, w, s


@pytest.mark.parametrize("params", [
    {"objective": "binary"},
    {"objective": "binary", "is_unbalance": True},
    {"objective": "binary", "scale_pos_weight": 2.5, "sigmoid": 1.7},
    {"objective": "binary", "_weight": True},
    {"objective": "regression"},
    {"objective": "regression", "_weight": True},
    {"objective": "regression", "reg_sqrt": True},
    {"objective": "regression", "boost_from_average": False},
])
def test_gradients_and_init_score_equal_jax(params):
    params = dict(params)
    weighted = params.pop("_weight", False)
    y, w, s = _labels(params["objective"])
    jo = jax_objective(JaxConfig.from_params(params))
    po = create_objective(Config.from_params(params))
    jo.init(JaxMetadata(label=y, weight=w if weighted else None), len(y))
    po.init(Metadata(label=y, weight=w if weighted else None), len(y), CPU)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    assert gp.dtype == hp.dtype == np.float32
    np.testing.assert_allclose(gp, gj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(hp, hj, rtol=4e-6, atol=1e-7)
    assert po.boost_from_score(0) == jo.boost_from_score(0)


@pytest.mark.parametrize("names, kind", [
    (["auc", "binary_logloss", "binary_error"], "binary"),
    (["l2", "rmse", "l1"], "regression"),
    ([], "binary"),                      # the objective's default metric
])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_equal_jax(names, kind, weighted):
    y, w, s = _labels(kind, seed=1)
    scores = (1.0 / (1.0 + np.exp(-s[0])) if kind == "binary"
              else s[0]).astype(np.float64)
    scores[::17] = scores[0]             # ties for the AUC
    params = {"objective": kind, "metric": names}
    wt = w if weighted else None
    jm = jax_metrics(JaxConfig.from_params(params),
                     JaxMetadata(label=y, weight=wt), len(y))
    pm = create_metrics(Config.from_params(params),
                        Metadata(label=y, weight=wt), len(y))
    assert [m.name for m in pm] == [m.name for m in jm]
    for a, b in zip(pm, jm):
        (na, va), = a.eval(scores)
        (nb, vb), = b.eval(scores)
        assert na == nb and a.greater_is_better == b.greater_is_better
        np.testing.assert_allclose(va, vb, rtol=1e-12)


def test_unported_metric_refuses():
    """Every metric of the JAX package is ported; a name no metric answers
    to is refused (the JAX package skips it with a warning)."""
    with pytest.raises(RuntimeError, match="Unknown metric multi_loss"):
        create_metrics(Config.from_params({"metric": ["multi_loss"]}),
                       Metadata(label=np.zeros(3, np.float32)), 3)


@pytest.mark.parametrize("cat", [False, True])
def test_predict_tree_binned_equals_jax(cat):
    """Per-tree validation scoring over the binned matrix: the JAX
    package's trees, traversed by both sides, give equal leaf values."""
    rng = np.random.RandomState(2)
    X = rng.randn(1500, 6)
    X[::6, 2] = np.nan
    X[::4, 3] = 0.0
    if cat:
        X[:, 0] = rng.randint(0, 15, 1500)
    y = X[:, 0] * 0.3 + np.nan_to_num(X[:, 2]) + X[:, 1] ** 2
    params = {"objective": "regression", "num_leaves": 31, "verbose": -1,
              "tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
              "zero_as_missing": False}
    ds = lgb.Dataset(X, label=y, categorical_feature=[0] if cat else "auto")
    bst = lgb.train(params, ds, 4)
    bds = ds.construct()
    meta = bds.feature_arrays()
    xb = bds.binned
    for tree in bst._booster.host_models:
        ja = jax_tta(tree, feature_meta=meta, use_inner_feature=True)
        depth = max(tree.max_depth, 1)
        ref = np.asarray(jax_ptb(jnp.asarray(xb), ja, depth))
        ta = to_device(tree_to_arrays(tree, feature_meta=meta,
                                      use_inner_feature=True), CPU)
        got = predict_tree_binned(torch.from_numpy(xb), ta, depth).numpy()
        np.testing.assert_array_equal(got, ref)
