"""The regression losses of the PyTorch port — L1, huber, fair, poisson,
quantile, mape, gamma, tweedie — and the L1 family's leaf refit, held to
the JAX package on the same numpy inputs.

Gradients are f32 on both sides and held at rtol 1e-6 / atol 1e-7. The
log-link losses take ``exp`` in float64, rounded once, where XLA takes its
own f32 ``exp``: the two differ by an ulp now and then, and a gradient
such as ``exp(s) - label`` cancels, so those losses also allow two ulps
(2^-22) of their exp terms' magnitude (``_exp_terms``). Init scores and
``weighted_percentile`` are exactly equal (the same numpy arithmetic);
metrics run the same float64 numpy code and are held at rtol 1e-12. Trained models, renewed ones included,
are held on the training rows at rtol 1e-4 / atol 1e-5
(``tests/test_torch_train.py``'s bar). Renewed runs under bagging use
``_discrete_data``: a bin holding only out-of-bag rows ties two thresholds
(ROADMAP.md Queue 3). The quantile loss's two gradient values make splits
of gain ~1e-6 (float noise) possible deep in a tree; those runs set
``min_gain_to_split=1e-3`` so that noise does not pick a split.
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
from lambdagap_tpu.objectives.base import \
    weighted_percentile as jax_percentile
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data.dataset import Metadata
from lambdagap_tpu_torch.metrics import create_metrics
from lambdagap_tpu_torch.objectives import create_objective
from lambdagap_tpu_torch.objectives.base import weighted_percentile
from test_torch_train import CPU, JAX_F32, _discrete_data, _fused_data

DEV = torch.device("cpu")
LOSSES = ["regression_l1", "huber", "fair", "poisson", "quantile", "mape",
          "gamma", "tweedie"]
POSITIVE = ("poisson", "gamma", "tweedie")      # log-link: labels >= 0


def _inputs(objective, n=3000, seed=0):
    rng = np.random.RandomState(seed)
    y = (rng.randn(n) * 3 + 1).astype(np.float32)
    if objective in POSITIVE:
        y = np.abs(y) + (0.1 if objective == "gamma" else 0.0)
        y[::7] = 0.0 if objective != "gamma" else y[::7]
    w = (rng.rand(n) + 0.5).astype(np.float32)
    s = (rng.randn(1, n) * (0.7 if objective in POSITIVE else 2.0)
         ).astype(np.float32)
    return y, w, s


def _exp_terms(params, y, s, w):
    """|the exp terms| of each log-link gradient and hessian, float64."""
    obj = params["objective"]
    s = s.astype(np.float64)
    if obj == "poisson":
        t = np.exp(s) * np.exp(params.get("poisson_max_delta_step", 0.7))
    elif obj == "gamma":
        t = np.abs(y) * np.exp(-s)
    elif obj == "tweedie":
        rho = params.get("tweedie_variance_power", 1.5)
        t = np.abs(y) * np.exp((1 - rho) * s) + np.exp((2 - rho) * s)
    else:
        return 0.0
    return t * (1.0 if w is None else w)


def _assert_grads_close(got, want, terms):
    """|got - want| <= 1e-7 + 1e-6 |want| + 2^-22 terms, elementwise."""
    bar = 1e-7 + 1e-6 * np.abs(want) + 2.0 ** -22 * terms
    excess = np.abs(got.astype(np.float64) - want) - bar
    assert excess.max() <= 0, (excess.max(), int((excess > 0).sum()))


@pytest.mark.parametrize("extra", [
    {}, {"_weight": True}, {"boost_from_average": False},
])
@pytest.mark.parametrize("objective", LOSSES)
def test_gradients_and_init_score_equal_jax(objective, extra):
    params = {"objective": objective, **extra}
    weighted = params.pop("_weight", False)
    y, w, s = _inputs(objective)
    wt = w if weighted else None
    jo = jax_objective(JaxConfig.from_params(params))
    po = create_objective(Config.from_params(params))
    jo.init(JaxMetadata(label=y, weight=wt), len(y))
    po.init(Metadata(label=y, weight=wt), len(y), DEV)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    assert gp.dtype == hp.dtype == np.float32
    terms = _exp_terms(params, y, s, wt)
    _assert_grads_close(gp, gj, terms)
    _assert_grads_close(hp, hj, terms)
    assert po.boost_from_score(0) == jo.boost_from_score(0)
    assert po.is_renew_tree_output == jo.is_renew_tree_output == (
        objective in ("regression_l1", "quantile", "mape"))


@pytest.mark.parametrize("params", [
    {"objective": "huber", "alpha": 0.3},
    {"objective": "fair", "fair_c": 0.37},
    {"objective": "poisson", "poisson_max_delta_step": 1.3},
    {"objective": "quantile", "alpha": 0.25},
    {"objective": "tweedie", "tweedie_variance_power": 1.1},
    {"objective": "tweedie", "tweedie_variance_power": 1.9},
])
def test_loss_parameters_reach_the_gradients_like_jax(params):
    y, w, s = _inputs(params["objective"], seed=3)
    jo = jax_objective(JaxConfig.from_params(params))
    po = create_objective(Config.from_params(params))
    jo.init(JaxMetadata(label=y, weight=w), len(y))
    po.init(Metadata(label=y, weight=w), len(y), DEV)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    terms = _exp_terms(params, y, s, w)
    _assert_grads_close(gp, gj, terms)
    _assert_grads_close(hp, hj, terms)
    assert po.boost_from_score(0) == jo.boost_from_score(0)


def test_negative_labels_refused_by_the_log_link_losses():
    y = np.array([1.0, -0.5, 2.0], np.float32)
    for obj in POSITIVE:
        po = create_objective(Config.from_params({"objective": obj}))
        with pytest.raises(RuntimeError, match="negative"):
            po.init(Metadata(label=y), 3, DEV)


@pytest.mark.parametrize("values, weights", [
    ([], None), ([2.5], None), ([2.5], [3.0]), ([3.0, 1.0], None),
    ([3.0, 1.0], [1.0, 4.0]), ([1.0, 1.0, 1.0, 2.0, 2.0], None),
    ([1.0, 1.0, 1.0, 2.0, 2.0], [0.5, 2.0, 1.0, 1.0, 3.0]),
    ([5.0, 1.0, 3.0, 3.0], [0.0, 0.0, 1.0, 0.0]),
    ("random", None), ("random", "random"),
])
@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.1])
def test_weighted_percentile_equals_jax_exactly(values, weights, alpha):
    """Ties, weights (zeros included) and n = 0 / 1 / 2, in f32 as the
    residuals arrive."""
    rng = np.random.RandomState(4)
    v = (rng.randn(501) if values == "random" else np.asarray(values)
         ).astype(np.float32)
    v[::5] = v[0] if len(v) > 5 else v[::5]
    w = (None if weights is None else
         (rng.rand(len(v)) if weights == "random" else np.asarray(weights)
          ).astype(np.float32))
    got = weighted_percentile(v, w, alpha)
    want = jax_percentile(v, w, alpha)
    assert type(got) is float and got == want


@pytest.mark.parametrize("metric", ["quantile", "huber", "fair", "poisson",
                                    "mape", "gamma", "gamma_deviance",
                                    "tweedie"])
@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_equal_jax(metric, weighted):
    objective = {"gamma_deviance": "gamma"}.get(metric, metric)
    y, w, s = _inputs(objective, seed=1)
    scores = s[0].astype(np.float64)
    if objective in POSITIVE:
        scores = np.exp(scores)
    params = {"objective": objective, "metric": [metric], "alpha": 0.7,
              "fair_c": 0.8, "tweedie_variance_power": 1.3}
    wt = w if weighted else None
    (jm,) = jax_metrics(JaxConfig.from_params(params),
                        JaxMetadata(label=y, weight=wt), len(y))
    (pm,) = create_metrics(Config.from_params(params),
                           Metadata(label=y, weight=wt), len(y))
    (nj, vj), = jm.eval(scores)
    (nt, vt), = pm.eval(scores)
    assert nt == nj == metric and not pm.greater_is_better
    np.testing.assert_allclose(vt, vj, rtol=1e-12)


def test_each_loss_defaults_to_its_own_metric():
    for obj in LOSSES:
        (m,) = create_metrics(Config.from_params({"objective": obj}),
                              Metadata(label=np.ones(3, np.float32)), 3)
        assert m.name == {"regression_l1": "l1"}.get(obj, obj)


def _train_both(params, X, y, rounds=8, w=None):
    out = []
    for pkg, extra in ((lgb, JAX_F32), (lgt, CPU)):
        out.append(pkg.train({**params, **extra},
                             pkg.Dataset(X, label=y, weight=w), rounds))
    return out


RENEW_CASES = [
    ("regression_l1", {}), ("quantile", {"alpha": 0.9}), ("mape", {}),
    ("regression_l1", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    ("quantile", {"alpha": 0.9, "bagging_fraction": 0.6, "bagging_freq": 2}),
    ("mape", {"bagging_fraction": 0.7, "bagging_freq": 1, "_weight": True}),
]


@pytest.mark.parametrize("objective, extra", RENEW_CASES)
def test_renewed_models_match_jax(objective, extra):
    """The host-tree path: every leaf refit by the weighted percentile of
    its in-bag residuals, the shrinkage in float64, the init score folded
    into the first tree."""
    extra = dict(extra)
    weighted = extra.pop("_weight", False)
    bagged = "bagging_fraction" in extra
    X, y = _discrete_data(seed=2) if bagged else _fused_data(seed=11)
    y = y * 10 + 40 if objective == "mape" else y
    w = np.random.RandomState(6).rand(len(y)) + 0.5 if weighted else None
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
              **extra}
    if objective == "quantile":
        params["min_gain_to_split"] = 1e-3
    bj, bt = _train_both(params, X, y, w=w)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    tj, tt = bj._booster.host_models, bt._booster.host_models
    assert [t.num_leaves for t in tt] == [t.num_leaves for t in tj]
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves], rtol=1e-5,
                                   atol=1e-6)
        assert a.shrinkage == b.shrinkage
    # the saved model reloads to the same predictions
    again = lgt.Booster(model_str=bt.model_to_string(), params=CPU)
    np.testing.assert_array_equal(again.predict(X), bt.predict(X))


def test_renew_path_stops_when_no_tree_splits_like_jax():
    """No leaf can split (min_data_in_leaf above half the rows): the first
    tree holds the init score, the run stops after it, as the JAX
    package's host-tree path does."""
    X, y = _fused_data(n=200, seed=3)
    params = {"objective": "regression_l1", "min_data_in_leaf": 150,
              "verbose": -1}
    for bfa in (True, False):
        bj, bt = _train_both({**params, "boost_from_average": bfa}, X, y,
                             rounds=5)
        assert len(bt._booster.models) == len(bj._booster.models) == 1
        np.testing.assert_array_equal(bt.predict(X), bj.predict(X))
        assert bt.predict(X)[0] == np.float32(np.median(
            y.astype(np.float32)))


@pytest.mark.parametrize("objective, extra", [
    ("huber", {"alpha": 0.5}), ("fair", {}), ("poisson", {}),
    ("gamma", {}), ("tweedie", {"tweedie_variance_power": 1.3}),
])
def test_other_losses_train_like_jax(objective, extra):
    X, y = _fused_data(seed=11)
    if objective in POSITIVE:
        y = np.exp(0.5 * y) + (0.05 if objective == "gamma" else 0.0)
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
              **extra}
    bj, bt = _train_both(params, X, y)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)
