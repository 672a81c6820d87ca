"""Cross-entropy objectives and metrics of the PyTorch port, and the
binary ``average_precision`` metric, held to the JAX package on the same
numpy inputs.

Gradients are f32 on both sides and held at rtol 1e-6 / atol 1e-7 (the
port takes each ``exp`` in float64, rounded once, where XLA takes its own
f32 one). Init scores are equal, metrics run the same float64 numpy code
(rtol 1e-12), and trained models are held on the training rows at rtol
1e-4 / atol 1e-5 (``tests/test_torch_train.py``'s bar).

The weighted ``cross_entropy_lambda`` cancels (``1 - y / z``, and
``1 - c * exp(-s) * (...)`` in its hessian), so one last bit of a
transcendental moves its value far past 1e-6. It is held bit for bit to
the JAX package with XLA's own ``exp`` and ``log1p`` in the port's place,
and with the port's own on every row where those agree. Its hessian is
the JAX package's, which is not the loss's curvature and turns negative
for trial counts above 1 (ROADMAP.md Queue 3); the trained model is held
to the JAX package's with trial counts in (0, 1], where that hessian stays
positive. Above 1 the JAX package's own run meets non-finite values.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax
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
from lambdagap_tpu_torch.objectives import xentropy as port_xentropy
from test_torch_train import CPU, JAX_F32, _fused_data

DEV = torch.device("cpu")


def _inputs(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.rand(n).astype(np.float32)
    y[::5] = np.round(y[::5])             # some hard 0 / 1 labels
    w = (rng.rand(n) * 2 + 0.2).astype(np.float32)
    s = (rng.randn(1, n) * 2).astype(np.float32)
    return y, w, s


def _cel_loss(y, w, s):
    z = 1.0 - np.exp(-w * np.log1p(np.exp(s)))
    return -(y * np.log(z) + (1 - y) * np.log(1 - z))


def _objectives(objective, y, wt):
    params = {"objective": objective}
    jo = jax_objective(JaxConfig.from_params(params))
    po = create_objective(Config.from_params(params))
    assert po.name == jo.name
    jo.init(JaxMetadata(label=y, weight=wt), len(y))
    po.init(Metadata(label=y, weight=wt), len(y), DEV)
    return jo, po


@pytest.mark.parametrize("objective, weighted", [
    ("cross_entropy", False), ("xentropy", True),
    ("cross_entropy_lambda", False), ("xentlambda", False),
])
def test_gradients_and_init_score_equal_jax(objective, weighted):
    y, w, s = _inputs()
    jo, po = _objectives(objective, y, w if weighted else None)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    assert gp.dtype == hp.dtype == np.float32
    np.testing.assert_allclose(gp, gj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=1e-7)
    assert po.boost_from_score(0) == jo.boost_from_score(0)


def _xla(fn):
    """A float32 torch -> torch function through XLA's own ``fn``."""
    f = jax.jit(fn)
    return lambda t: torch.from_numpy(np.array(f(t.numpy())))


def test_weighted_cross_entropy_lambda_equals_jax(monkeypatch):
    """With XLA's ``exp`` and ``log1p`` in place of the port's float64
    ones, the weighted gradient and hessian are the JAX package's bit for
    bit (its float32 operations in order, XLA's two multiply-adds rounded
    once). With the port's own they are equal on every row where XLA's
    four transcendental values equal the float64 ones rounded once."""
    y, w, s = _inputs(seed=2)
    jo, po = _objectives("cross_entropy_lambda", y, w)
    gj, hj = (np.asarray(a) for a in jo.get_gradients_fast(jnp.asarray(s)))
    gp, hp = (a.numpy() for a in po.get_gradients_fast(torch.from_numpy(s)))
    # the rows where XLA's exp(s), exp(-s), log1p(exp(s)) and
    # exp(-w * log1p(exp(s))) are the float64 values rounded once
    x_exp, x_log1p = _xla(jnp.exp), _xla(jnp.log1p)
    st, wt = torch.from_numpy(s), torch.from_numpy(w)[None, :]
    agree = np.ones(s.shape, bool)
    for port_fn, xla_fn, arg in (
            (port_xentropy.exp64, x_exp, lambda: st),
            (port_xentropy.exp64, x_exp, lambda: -st),
            (port_xentropy.log1p64, x_log1p, lambda: x_exp(st)),
            (port_xentropy.exp64, x_exp,
             lambda: -wt * x_log1p(x_exp(st)))):
        agree &= (port_fn(arg()) == xla_fn(arg())).numpy()
    assert 0.5 < agree.mean() < 1.0
    np.testing.assert_array_equal(gp[agree], gj[agree])
    np.testing.assert_array_equal(hp[agree], hj[agree])
    monkeypatch.setattr(port_xentropy, "exp64", x_exp)
    monkeypatch.setattr(port_xentropy, "log1p64", x_log1p)
    gx, hx = (a.numpy() for a in po.get_gradients_fast(st))
    assert gx.dtype == hx.dtype == np.float32
    np.testing.assert_array_equal(gx, gj)
    np.testing.assert_array_equal(hx, hj)
    assert po.boost_from_score(0) == jo.boost_from_score(0)


def test_weighted_cross_entropy_lambda_hessian_is_not_the_curvature():
    """The reference's fault the port keeps (ROADMAP.md Queue 3): the
    weighted hessian, the JAX package's expression, turns negative on rows
    with more than one trial, where the loss's second difference is
    positive; with at most one trial it stays non-negative."""
    y, w, s = _inputs(seed=2)
    jo, po = _objectives("cross_entropy_lambda", y, w)
    hj = np.asarray(jo.get_gradients_fast(jnp.asarray(s))[1])[0]
    hp = po.get_gradients_fast(torch.from_numpy(s))[1].numpy()[0]
    y64, w64, s64 = (a.astype(np.float64) for a in (y, w, s[0]))
    e = 1e-3
    curvature = (_cel_loss(y64, w64, s64 + e) - 2 * _cel_loss(y64, w64, s64)
                 + _cel_loss(y64, w64, s64 - e)) / (e * e)
    negative = hp < 0
    assert negative.any()
    np.testing.assert_array_equal(negative, hj < 0)
    assert (w[negative] > 1).all()
    assert (curvature[negative] > 0).all()
    assert (hp[w <= 1] >= 0).all()


def test_labels_outside_the_unit_interval_refuse():
    y = np.array([0.2, 1.5, 0.0], np.float32)
    for obj in ("cross_entropy", "cross_entropy_lambda"):
        po = create_objective(Config.from_params({"objective": obj}))
        with pytest.raises(RuntimeError, match=r"\[0, 1\]"):
            po.init(Metadata(label=y), 3, DEV)


@pytest.mark.parametrize("metric", ["cross_entropy", "cross_entropy_lambda",
                                    "kldiv", "average_precision"])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_equal_jax(metric, weighted):
    y, w, s = _inputs(seed=1)
    raw = s[0].astype(np.float64)
    if metric == "cross_entropy_lambda":
        scores = np.log1p(np.exp(raw))
    else:
        scores = 1.0 / (1.0 + np.exp(-raw))
        scores[::11] = scores[0]          # ties for average_precision
    if metric == "average_precision":
        y = (y > 0.5).astype(np.float32)
    params = {"metric": [metric]}
    wt = w if weighted else None
    (jm,) = jax_metrics(JaxConfig.from_params(params),
                        JaxMetadata(label=y, weight=wt), len(y))
    (pm,) = create_metrics(Config.from_params(params),
                           Metadata(label=y, weight=wt), len(y))
    (nj, vj), = jm.eval(scores)
    (nt, vt), = pm.eval(scores)
    assert nt == nj == metric
    assert pm.greater_is_better == jm.greater_is_better
    np.testing.assert_allclose(vt, vj, rtol=1e-12)


def test_average_precision_without_positives_is_one():
    (pm,) = create_metrics(Config.from_params({"metric": ["average_precision"]}),
                           Metadata(label=np.zeros(4, np.float32)), 4)
    assert pm.eval(np.array([0.1, 0.9, 0.3, 0.2])) == [
        ("average_precision", 1.0)]


@pytest.mark.parametrize("objective, weighted", [
    ("cross_entropy", False), ("cross_entropy", True),
    ("cross_entropy_lambda", False), ("cross_entropy_lambda", True),
])
def test_trained_models_match_jax(objective, weighted):
    """Probabilistic labels from a logistic of the regression score, with
    and without weights, and the default metric's history on the training
    rows. cross_entropy_lambda's weights are trial counts in (0.2, 1]: its
    hessian (the JAX package's) turns negative above one trial, where the
    JAX package's own run on these labels meets non-finite values."""
    X, z = _fused_data(seed=11)
    y = 1.0 / (1.0 + np.exp(-z))
    scale = 0.8 if objective == "cross_entropy_lambda" else 2.0
    low = 0.2 if objective == "cross_entropy_lambda" else 0.5
    w = (np.random.RandomState(7).rand(len(y)) * scale + low if weighted
         else None)
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
              "boost_from_average": False}
    boosters, hist = {}, {}
    for pkg, extra in ((lgb, JAX_F32), (lgt, CPU)):
        ds = pkg.Dataset(X, label=y, weight=w)
        res = {}
        boosters[pkg] = pkg.train(
            {**params, **extra}, ds, 8,
            valid_sets=[pkg.Dataset(X, label=y, weight=w, reference=ds)],
            callbacks=[pkg.record_evaluation(res)])
        hist[pkg] = res["valid_0"]
    bt = boosters[lgt]
    assert list(hist[lgt]) == [objective]
    assert hist[lgt][objective][-1] < hist[lgt][objective][0]
    bj = boosters[lgb]
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hist[lgt][objective], hist[lgb][objective],
                               rtol=1e-6)
