"""Multiclass (softmax and one-vs-all) in the PyTorch port, held to the JAX
package on the same numpy inputs.

Gradients are f32 on both sides and held at rtol 1e-6 / atol 1e-7. The
softmax's ``exp`` is float64 rounded once in the port and XLA's own f32
``exp`` in the JAX package, so the probabilities differ by an ulp now and
then; the hessian ``K/(K-1) * p * (1 - p)`` cancels in ``1 - p`` near
p = 1, where one ulp of p (6e-8) times the factor (at most 2) reaches
1.2e-7, so hessians take atol 2e-7. Init scores are equal (the same numpy
arithmetic); metrics run the same float64 numpy code and are held at rtol
1e-12. Trained models are held on the training rows at rtol 1e-4 / atol
1e-5 (``tests/test_torch_train.py``'s bar); validation histories on the
training rows at rtol 1e-6, with ``boost_from_average=false`` (the JAX
fast path counts the init score twice on validation scores; ROADMAP.md
Queue 3). GOSS runs on ``_discrete_data``: under sampling, a bin holding
only out-of-bag rows ties two thresholds (Queue 3).
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data.dataset import Metadata as JaxMetadata
from lambdagap_tpu.metrics import create_metrics as jax_metrics
from lambdagap_tpu.objectives.base import create_objective as jax_objective
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data.dataset import Metadata
from lambdagap_tpu_torch.metrics import create_metrics
from lambdagap_tpu_torch.objectives import create_objective
from test_torch_train import CPU, JAX_F32, _discrete_data

DEV = torch.device("cpu")


def _labels(K, n=3000, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, K, n).astype(np.float32)
    y[: n // 3] = 0                       # unequal class priors
    w = (rng.rand(n) + 0.5).astype(np.float32)
    s = (rng.randn(K, n) * 2).astype(np.float32)
    return y, w, s


@pytest.mark.parametrize("params", [
    {"objective": "multiclass", "num_class": 4},
    {"objective": "multiclass", "num_class": 7, "_weight": True},
    {"objective": "multiclass", "num_class": 3, "boost_from_average": False},
    {"objective": "multiclassova", "num_class": 4},
    {"objective": "multiclassova", "num_class": 7, "_weight": True},
    {"objective": "multiclassova", "num_class": 3, "is_unbalance": True,
     "sigmoid": 1.5},
])
def test_gradients_and_init_scores_equal_jax(params):
    params = dict(params)
    weighted = params.pop("_weight", False)
    K = params["num_class"]
    y, w, s = _labels(K)
    wt = w if weighted else None
    jo = jax_objective(JaxConfig.from_params(params))
    po = create_objective(Config.from_params(params))
    jo.init(JaxMetadata(label=y, weight=wt), len(y))
    po.init(Metadata(label=y, weight=wt), len(y), DEV)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    assert gp.shape == hp.shape == (K, len(y))
    assert gp.dtype == hp.dtype == np.float32
    np.testing.assert_allclose(gp, gj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=2e-7)
    assert [po.boost_from_score(k) for k in range(K)] == \
        [jo.boost_from_score(k) for k in range(K)]


def test_softmax_label_outside_the_classes_refuses():
    po = create_objective(Config.from_params({"objective": "multiclass",
                                              "num_class": 3}))
    with pytest.raises(RuntimeError, match="num_class"):
        po.init(Metadata(label=np.array([0, 1, 3], np.float32)), 3, DEV)


@pytest.mark.parametrize("metric, extra", [
    ("multi_logloss", {}),
    ("multi_error", {}),
    ("multi_error", {"multi_error_top_k": 2}),
    ("auc_mu", {}),
    ("auc_mu", {"auc_mu_weights": [0, 1, 2, 3, 1, 0, 1, 2, 2, 1, 0, 1,
                                   3, 2, 1, 0]}),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_metrics_equal_jax(metric, extra, weighted):
    y, w, s = _labels(4, seed=1)
    e = np.exp(s - s.max(0))
    prob = (e / e.sum(0)).astype(np.float64)
    prob[:, ::13] = prob[:, :1]            # ties for the AUC and the ranks
    params = {"objective": "multiclass", "num_class": 4, "metric": [metric],
              **extra}
    wt = w if weighted else None
    (jm,) = jax_metrics(JaxConfig.from_params(params),
                        JaxMetadata(label=y, weight=wt), len(y))
    (pm,) = create_metrics(Config.from_params(params),
                           Metadata(label=y, weight=wt), len(y))
    (nj, vj), = jm.eval(prob)
    (nt, vt), = pm.eval(prob)
    assert nt == nj and pm.greater_is_better == jm.greater_is_better
    if extra.get("multi_error_top_k"):
        assert nt == "multi_error@2"
    np.testing.assert_allclose(vt, vj, rtol=1e-12)


def test_default_metric_of_multiclass_is_multi_logloss():
    for obj in ("multiclass", "softmax", "multiclassova", "ova"):
        ms = create_metrics(Config.from_params({"objective": obj,
                                                "num_class": 3}),
                            Metadata(label=np.zeros(3, np.float32)), 3)
        assert [m.name for m in ms] == ["multi_logloss"]


def _categorical_data(n=1200, seed=11, K=4):
    """test_torch_train's ``_fused_data`` with a 12-category column and
    its score cut at the quartiles into K = 4 classes."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[:, 0] = rng.randint(0, 12, n)
    z = (X[:, 1] + np.sin(X[:, 2] * 2) + (X[:, 0] % 3) * 0.5
         + 0.3 * rng.randn(n))
    return X, np.digitize(z, np.quantile(z, [0.25, 0.5, 0.75])).astype(
        np.float64)


@pytest.mark.parametrize("case", ["softmax", "ova", "goss", "weighted"])
def test_trained_multiclass_matches_jax(case):
    """4-class softmax and ova with a categorical column, softmax under
    GOSS past its warm-up (|g*h| summed over the classes), and weighted
    softmax: training-row raw scores, leaves per tree, and the validation
    histories of the three multiclass metrics."""
    params = {"objective": "multiclassova" if case == "ova" else "multiclass",
              "num_class": 4, "num_leaves": 15, "min_data_in_leaf": 20,
              "learning_rate": 0.1, "boost_from_average": False,
              "metric": ["multi_logloss", "multi_error", "auc_mu"],
              "verbose": -1}
    cats = [0]
    w = None
    if case == "goss":
        X, z = _discrete_data(seed=1)
        y = np.digitize(z, np.quantile(z, [0.25, 0.5, 0.75])).astype(float)
        params.update(data_sample_strategy="goss", learning_rate=0.5)
        cats = "auto"
    else:
        X, y = _categorical_data()
        if case == "weighted":
            w = np.random.RandomState(5).rand(len(y)) + 0.5
    hist = {}
    boosters = {}
    for pkg, extra in ((lgb, JAX_F32), (lgt, CPU)):
        ds = pkg.Dataset(X, label=y, weight=w, categorical_feature=cats)
        res = {}
        boosters[pkg] = pkg.train(
            {**params, **extra}, ds, 8,
            valid_sets=[pkg.Dataset(X, label=y, weight=w, reference=ds,
                                    categorical_feature=cats)],
            callbacks=[pkg.record_evaluation(res)])
        hist[pkg] = res["valid_0"]
    bj, bt = boosters[lgb], boosters[lgt]
    assert bt._booster.num_tree_per_iteration == 4
    rj, rt = bj.predict(X, raw_score=True), bt.predict(X, raw_score=True)
    assert rt.shape == rj.shape == (len(y), 4)
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]
    if cats == [0]:
        assert any(any(t.is_categorical) for t in bt._booster.host_models)
    assert sorted(hist[lgt]) == sorted(hist[lgb])
    for name, values in hist[lgb].items():
        np.testing.assert_allclose(hist[lgt][name], values, rtol=1e-6)
    assert hist[lgt]["multi_logloss"][-1] < hist[lgt]["multi_logloss"][0]


def test_early_stopping_on_multi_logloss_matches_jax():
    """Early stopping reads the validation multi_logloss: a held-out
    validation set, the same best iteration as the JAX package."""
    X, y = _categorical_data(n=900, seed=12)
    params = {"objective": "multiclass", "num_class": 4, "num_leaves": 15,
              "min_data_in_leaf": 5, "learning_rate": 0.8,
              "boost_from_average": False, "verbose": -1}
    best = {}
    for pkg, extra in ((lgb, JAX_F32), (lgt, CPU)):
        tr = pkg.Dataset(X[:600], label=y[:600], categorical_feature=[0])
        bst = pkg.train({**params, **extra}, tr, 20,
                        valid_sets=[pkg.Dataset(X[600:], label=y[600:],
                                                reference=tr)],
                        callbacks=[pkg.early_stopping(2, verbose=False)])
        best[pkg] = bst.best_iteration
    assert best[lgt] == best[lgb]
    assert 0 < best[lgt] < 20
