"""The training API on the CPU, held to the JAX package on the same numpy
inputs: custom gradients (``Booster.update(fobj=)``, ``objective=none``),
``feval``, ``init_model`` (from a port booster and from a model text the
JAX package wrote), a validation set added after training began,
``reset_parameter`` and the ``Dataset`` setters.

The JAX side runs its fused learner with full-f32 one-hot histograms
(``JAX_F32``, as ``tests/test_torch_train.py``). Predictions are compared
on the training rows at rtol 1e-4 / atol 1e-5: thresholds tied across
bins that hold no training row may route validation rows differently, so
validation predictions are held only to the port's own scores.
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


def _data(n=1600, d=10, seed=3, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    z = X @ rng.randn(d) + 0.3 * X[:, 0] * X[:, 1] + 0.3 * rng.randn(n)
    if classes == 2:
        y = (z > 0).astype(np.float64)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)
    return X[:1200], y[:1200], X[1200:], y[1200:]


def _exp32(x):
    """``exp`` in float64 rounded once to float32, as the port's
    objectives take it."""
    return np.exp(x.astype(np.float64)).astype(np.float32)


def binary_fobj(preds, train_data):
    """The binary logloss gradients, as the built-in objective computes
    them (sigmoid 1), flat."""
    ls = np.where(train_data.metadata.label == 1, 1.0, -1.0).astype(
        np.float32)
    response = -ls / (np.float32(1) + _exp32(ls * preds.astype(np.float32)))
    abs_r = np.abs(response)
    return response, abs_r * (np.float32(1) - abs_r)


def softmax_fobj(preds, train_data):
    """The softmax gradients of ``multiclass``, flat and class-major."""
    s = preds.T.astype(np.float32)                   # [K, N]
    K = s.shape[0]
    e = _exp32(s - s.max(axis=0))
    tot = e[0].copy()
    for k in range(1, K):
        tot += e[k]
    p = e / tot
    onehot = (train_data.metadata.label[None, :]
              == np.arange(K)[:, None]).astype(np.float32)
    grad = p - onehot
    hess = np.float32(K / (K - 1.0)) * p * (np.float32(1) - p)
    return grad.reshape(-1), hess.reshape(-1)


@pytest.mark.parametrize("classes", [2, 3])
def test_fobj_matches_the_builtin_objective(classes):
    """``objective=none`` with a flat fobj trains the trees the JAX
    package trains with the built-in objective (no boost from average:
    custom gradients skip it in both packages)."""
    X, y, _, _ = _data(classes=classes)
    builtin = ({"objective": "binary"} if classes == 2 else
               {"objective": "multiclass", "num_class": 3})
    fobj = binary_fobj if classes == 2 else softmax_fobj
    params = {**BASE, **builtin, "boost_from_average": False}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 6)
    custom = {**BASE, "objective": "none",
              **({"num_class": 3} if classes == 3 else {})}
    bt = lgt.Booster(params={**custom, **CPU},
                     train_set=lgt.Dataset(X, label=y))
    for _ in range(6):
        bt.update(fobj=fobj)
    assert bt.num_trees() == 6 * (1 if classes == 2 else 3)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), **BAR)


def test_no_objective_and_no_gradients_fails_like_jax():
    X, y, _, _ = _data()
    bt = lgt.Booster(params={**BASE, **CPU, "objective": "none"},
                     train_set=lgt.Dataset(X, label=y))
    with pytest.raises(RuntimeError, match="No objective and no custom "
                       "gradients"):
        bt.update()


def logloss_feval(preds, data):
    p = np.clip(preds, 1e-15, 1 - 1e-15)
    y = data.metadata.label
    return ("my_logloss",
            float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))), False)


def test_feval_histories_match_jax():
    """feval runs on the converted scores of every evaluated set, after the
    built-in metrics; the training set's history equals the JAX package's
    and the validation value equals the built-in binary_logloss."""
    X, y, Xv, yv = _data()
    params = {**BASE, "metric": "binary_logloss"}
    ev_t, ev_j = {}, {}
    tr_t = lgt.Dataset(X, label=y)
    va_t = lgt.Dataset(Xv, label=yv, reference=tr_t)
    lgt.train({**params, **CPU}, tr_t, 5, valid_sets=[tr_t, va_t],
              valid_names=["train", "valid"], feval=logloss_feval,
              callbacks=[lgt.record_evaluation(ev_t)])
    tr_j = lgb.Dataset(X, label=y)
    va_j = lgb.Dataset(Xv, label=yv, reference=tr_j)
    lgb.train({**params, **JAX_F32}, tr_j, 5, valid_sets=[tr_j, va_j],
              valid_names=["train", "valid"], feval=logloss_feval,
              callbacks=[lgb.record_evaluation(ev_j)])
    assert list(ev_t["valid"]) == list(ev_j["valid"]) == [
        "binary_logloss", "my_logloss"]
    np.testing.assert_allclose(ev_t["train"]["my_logloss"],
                               ev_j["train"]["my_logloss"], rtol=1e-5)
    np.testing.assert_allclose(ev_t["valid"]["my_logloss"],
                               ev_t["valid"]["binary_logloss"], rtol=1e-6)
    assert ev_t["valid"]["my_logloss"][-1] < ev_t["valid"]["my_logloss"][0]


def test_init_model_from_a_port_booster_matches_jax_and_straight_training():
    """tests/test_continued.py's bar: 5 + 5 continued rounds predict like
    10 straight ones; and like the JAX package's own continuation."""
    X, y, _, _ = _data()
    params = {**BASE, "deterministic": True}
    b5 = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5)
    more = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5,
                     init_model=b5)
    assert more.num_trees() == 10 and b5.num_trees() == 5
    straight = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 10)
    np.testing.assert_allclose(more.predict(X, raw_score=True),
                               straight.predict(X, raw_score=True), **BAR)
    j5 = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 5)
    jmore = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 5,
                      init_model=j5)
    np.testing.assert_allclose(more.predict(X, raw_score=True),
                               jmore.predict(X, raw_score=True), **BAR)


def test_init_model_from_a_jax_written_text_trains_the_jax_trees(tmp_path):
    """The weights carried across: a model text the JAX package wrote,
    loaded into the port and continued (as a Booster and as a file), trains
    the trees the JAX package trains continuing the same text."""
    X, y, _, _ = _data(seed=5)
    X[::11, 2] = np.nan
    params = {**BASE, "objective": "regression", "metric": "l2"}
    y = X[:, 0] + np.nan_to_num(X[:, 2]) * 0.5 + 0.1 * y
    text = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y),
                     4).model_to_string()
    path = tmp_path / "jax_model.txt"
    path.write_text(text)
    jmore = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 4,
                      init_model=lgb.Booster(model_str=text))
    loaded = lgt.Booster(model_str=text, params=CPU)
    before = loaded.model_to_string()
    for init in (loaded, str(path)):
        more = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 4,
                         init_model=init)
        assert more.num_trees() == 8
        np.testing.assert_allclose(more.predict(X),
                                   jmore.predict(X), **BAR)
    # the caller's trees are deep-copied before rebinding
    assert loaded.model_to_string() == before


def test_init_model_replays_the_scores_it_continues_from():
    X, y, Xv, yv = _data()
    b5 = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 5)
    tr = lgt.Dataset(X, label=y)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    more = lgt.train({**BASE, **CPU}, tr, 0, valid_sets=[va],
                     init_model=b5)
    gb = more._booster
    np.testing.assert_allclose(gb.scores[0].numpy(),
                               b5.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gb.valid_scores[0][0].numpy(),
                               b5.predict(Xv, raw_score=True), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_a_late_validation_set_replays_the_trees(boosting):
    """A validation set added after training began takes the existing
    trees' scores, then each later tree's."""
    X, y, Xv, yv = _data()
    params = {**BASE, **CPU, "boosting": boosting, "drop_rate": 0.5,
              "skip_drop": 0.0, "metric": "binary_logloss"}
    tr = lgt.Dataset(X, label=y)
    bst = lgt.Booster(params=params, train_set=tr)
    for _ in range(3):
        bst.update()
    bst.add_valid(lgt.Dataset(Xv, label=yv, reference=tr), "late")
    gb = bst._booster
    np.testing.assert_allclose(gb.valid_scores[0][0].numpy(),
                               bst.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    bst.update()
    np.testing.assert_allclose(gb.valid_scores[0][0].numpy(),
                               bst.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    (name, metric, value, _), = bst.eval_valid()
    assert (name, metric) == ("late", "binary_logloss")
    assert np.isfinite(value)


@pytest.mark.parametrize("schedule", [
    {"learning_rate": [0.1, 0.05, 0.2, 0.02, 0.1]},
    {"lambda_l2": [0.0, 10.0, 10.0, 100.0, 0.0]},
])
def test_reset_parameter_matches_jax(schedule):
    """A learning-rate schedule becomes each round's shrinkage; a learner
    knob changed mid-run acts in the port exactly where it acts in the JAX
    package (its learners copy the split parameters when built)."""
    X, y, _, _ = _data()
    bj = lgb.train({**BASE, **JAX_F32}, lgb.Dataset(X, label=y), 5,
                   callbacks=[lgb.reset_parameter(**schedule)])
    bt = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 5,
                   callbacks=[lgt.reset_parameter(**schedule)])
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), **BAR)
    key, values = next(iter(schedule.items()))
    assert getattr(bt.config, key) == values[-1]
    if key == "learning_rate":
        shrink = [float(ln.split("=")[1])
                  for ln in bt.model_to_string().splitlines()
                  if ln.startswith("shrinkage=")]
        np.testing.assert_allclose(shrink, values, rtol=1e-12)


def test_reset_parameter_runs_before_the_round():
    """``before_iteration`` callbacks run before the round's update: the
    first round already trains at the schedule's first rate."""
    X, y, _, _ = _data()
    seen = []

    def probe(env):
        seen.append(env.model._booster.shrinkage_rate)
    probe.before_iteration = True
    probe.order = 20
    lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 3,
              callbacks=[probe, lgt.reset_parameter(
                  learning_rate=[0.3, 0.2, 0.1])])
    assert seen == [0.3, 0.2, 0.1]


def test_dataset_setters_reach_the_binned_dataset():
    X, y, _, _ = _data()
    w = np.linspace(0.5, 1.5, len(y))
    ds = lgt.Dataset(X, label=np.zeros_like(y), free_raw_data=False)
    ds.set_label(y).set_weight(w).set_init_score(np.full(len(y), 0.25))
    assert ds.get_weight() is w
    built = ds.construct(lgt.Config.from_params(CPU))
    np.testing.assert_array_equal(built.metadata.label, y.astype(np.float32))
    np.testing.assert_array_equal(ds.get_weight(), w.astype(np.float32))
    ds.set_label(1 - y).set_weight(w[::-1]).set_init_score(
        np.zeros(len(y)))
    np.testing.assert_array_equal(built.metadata.label,
                                  (1 - y).astype(np.float32))
    np.testing.assert_array_equal(built.metadata.weight,
                                  w[::-1].astype(np.float32))
    np.testing.assert_array_equal(built.metadata.init_score,
                                  np.zeros(len(y)))
    # weighted training on the setters' data equals the JAX package's
    params = {**BASE, "metric": "binary_logloss"}
    bt = lgt.train({**params, **CPU},
                   lgt.Dataset(X, free_raw_data=False).set_label(y)
                   .set_weight(w), 4)
    bj = lgb.train({**params, **JAX_F32},
                   lgb.Dataset(X).set_label(y).set_weight(w), 4)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), **BAR)


def test_subset_bins_with_the_parent_mappers_like_jax():
    X, y, _, _ = _data()
    w = np.linspace(0.5, 1.5, len(y))
    cfg = lgt.Config.from_params(CPU)
    full = lgt.Dataset(X, label=y, weight=w, free_raw_data=False)
    idx = np.arange(0, len(y), 3)
    sub = full.subset(idx)
    assert sub.reference is full and np.array_equal(sub.used_indices, idx)
    built = sub.construct(cfg)
    fj = lgb.Dataset(X, label=y, weight=w, free_raw_data=False)
    sj = fj.subset(idx).construct()
    np.testing.assert_array_equal(built.binned, sj.binned)
    np.testing.assert_array_equal(built.binned,
                                  full.construct(cfg).binned[idx])
    np.testing.assert_array_equal(built.metadata.weight, w[idx].astype(
        np.float32))
    freed = lgt.Dataset(X, label=y)
    freed.construct(cfg)
    assert freed.data is None
    with pytest.raises(RuntimeError, match="free_raw_data=False"):
        freed.subset(idx)
