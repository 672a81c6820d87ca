"""Training on the CPU: the port's ``lgt.train`` held to the JAX package's
fused learner (``tpu_fused_learner=1``) on the same numpy inputs.

The JAX side runs its one-hot histograms in full f32
(``tpu_hist_impl=onehot``, ``tpu_hist_precision=f32``), so a near-tie does
not flip a split through the bf16 split precision alone, and once on its
Pallas kernel in interpret mode (at 400 rows: interpret mode is ~100x
slow).

Predictions are compared on the TRAINING rows at rtol 1e-4 / atol 1e-5
(``tests/test_fused.py:54``'s bar): the two sides sum histograms in
different orders, and two thresholds separated only by bins that hold no
training row of the leaf split the training rows identically with gains
equal up to the last bits — either may win. Such a pair routes no training
row differently, but may route a validation row differently, which is why
validation predictions are not held to this bar.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.convert import dataset_fields, dataset_from_numpy

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}


def _fused_data(n=1200, d=8, seed=11, cat=False):
    """tests/test_fused.py's data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    if cat:
        X[:, 0] = rng.randint(0, 12, n)
    y = (X[:, 1] + np.sin(X[:, 2] * 2)
         + (X[:, 0] % 3 if cat else X[:, 3]) * 0.5 + 0.1 * rng.randn(n))
    return X, y


@pytest.mark.parametrize("extra", [
    {},
    {"max_depth": 3},
    {"_cat": True},
    {"lambda_l1": 0.5, "lambda_l2": 2.0},
    {"feature_fraction": 0.6, "feature_fraction_seed": 3,
     "min_data_in_leaf": 5, "num_leaves": 31},
])
def test_regression_matches_jax_fused(extra):
    """tests/test_fused.py's shapes and options (its bagging case is
    test_sampled_training_matches_jax's)."""
    extra = dict(extra)
    cat = extra.pop("_cat", False)
    X, y = _fused_data(cat=cat)
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
              **extra}
    cf = [0] if cat else "auto"
    bj = lgb.train({**params, **JAX_F32},
                   lgb.Dataset(X, label=y, categorical_feature=cf), 8)
    bt = lgt.train({**params, **CPU},
                   lgt.Dataset(X, label=y, categorical_feature=cf), 8)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    tj, tt = bj._booster.host_models, bt._booster.host_models
    assert [t.num_leaves for t in tt] == [t.num_leaves for t in tj]
    if extra.get("max_depth"):
        assert max(t.max_depth for t in tt) <= extra["max_depth"]
    if cat:
        assert any(any(t.is_categorical) for t in tt)


def _binary_data():
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.8 * rng.randn(5000) > 0.3
         ).astype(np.float64)
    return X[:4000], y[:4000], X[4000:], y[4000:]


def _train_binary(mod, params, Xt, yt, Xv, yv, device):
    ev = {}
    tr = mod.Dataset(Xt, label=yt)
    extra = CPU if device else JAX_F32
    bst = mod.train({**params, **extra}, tr, 60,
                    valid_sets=[mod.Dataset(Xv, label=yv, reference=tr)],
                    callbacks=[mod.early_stopping(5, verbose=False),
                               mod.record_evaluation(ev)])
    return bst, ev["valid_0"]


def test_binary_example_early_stopping_matches_jax():
    """The binary example's flow with a validation set and early stopping:
    the same best_iteration and the same evaluation history. The history is
    held at rtol 1e-6: its values are float64 metrics of f32 scores that
    differ in the last bits (histogram summation order, and torch's exp
    against XLA's)."""
    Xt, yt, Xv, yv = _binary_data()
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": 15, "learning_rate": 0.3, "verbose": -1,
              "boost_from_average": False}
    bj, hj = _train_binary(lgb, params, Xt, yt, Xv, yv, None)
    bt, ht = _train_binary(lgt, params, Xt, yt, Xv, yv, "cpu")
    assert bt.best_iteration == bj.best_iteration > 0
    assert bt.best_iteration < 60           # early stopping fired
    for m in ("auc", "binary_logloss"):
        assert len(ht[m]) == len(hj[m])
        np.testing.assert_allclose(ht[m], hj[m], rtol=1e-6)
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), rtol=1e-4,
                               atol=1e-5)
    assert bt.best_score["valid_0"] == pytest.approx(
        bj.best_score["valid_0"], rel=1e-6)


def test_boost_from_average_counted_once_on_validation_scores():
    """With boost_from_average the init score enters the validation scores
    once. A validation set holding the training rows therefore scores
    exactly like the training set — the port's validation history equals
    the JAX package's TRAINING history (whose fused fast path adds the init
    score to its own validation scores a second time; ROADMAP.md Queue 3)."""
    Xt, yt, _, _ = _binary_data()
    Xt, yt = Xt[:2000], yt[:2000]
    params = {"objective": "binary", "metric": ["binary_logloss"],
              "num_leaves": 7, "learning_rate": 0.3, "verbose": -1}
    ej, et = {}, {}
    trj = lgb.Dataset(Xt, label=yt)
    lgb.train({**params, **JAX_F32}, trj, 6,
              valid_sets=[trj, lgb.Dataset(Xt, label=yt, reference=trj)],
              valid_names=["training", "copy"],
              callbacks=[lgb.record_evaluation(ej)])
    trt = lgt.Dataset(Xt, label=yt)
    lgt.train({**params, **CPU}, trt, 6,
              valid_sets=[lgt.Dataset(Xt, label=yt, reference=trt)],
              callbacks=[lgt.record_evaluation(et)])
    np.testing.assert_allclose(et["valid_0"]["binary_logloss"],
                               ej["training"]["binary_logloss"], rtol=1e-6)
    # the reference's own copy of the training rows scores worse: the
    # init score counted twice
    assert all(c > t * 1.001 for c, t in zip(
        ej["copy"]["binary_logloss"], ej["training"]["binary_logloss"]))


def test_matches_jax_on_its_pallas_kernel():
    """One small run against the JAX package on its Pallas histogram
    kernel (interpret mode on the CPU)."""
    rng = np.random.RandomState(4)
    X = rng.randn(400, 5)
    X[::9, 1] = np.nan
    y = (X[:, 0] - np.nan_to_num(X[:, 1]) > 0.2).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
              "verbose": -1}
    bj = lgb.train({**params, "tpu_fused_learner": "1",
                    "tpu_hist_impl": "pallas"}, lgb.Dataset(X, label=y), 3)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 3)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_identical_binned_matrix_through_convert():
    """The JAX package's binned dataset carried across as numpy: the port's
    learner on the identical matrix gives the JAX learner's model."""
    X, y = _fused_data(seed=12)
    X[::5, 4] = 0.0
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "zero_as_missing": True}
    dj = lgb.Dataset(X, label=y)
    bj = lgb.train({**params, **JAX_F32}, dj, 6)
    ds = dataset_from_numpy(dataset_fields(dj.construct()))
    bt = lgt.train({**params, **CPU}, lgt.Dataset(ds), 6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_train_save_reload_serve(tmp_path):
    """Train -> save -> Booster(model_str=) -> served raw scores equal to
    the trained booster's own predictions, and the reload's trees are
    byte-stable."""
    X, y = _fused_data(seed=13, cat=True)
    X[::11, 5] = np.nan
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              **CPU}
    bst = lgt.train(params, lgt.Dataset(X, label=(y > 0.5).astype(float),
                                        categorical_feature=[0]), 6)
    raw = bst.predict(X, raw_score=True)
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    text = path.read_text()
    re = lgt.Booster(model_str=text, params=CPU)
    # the trees region round-trips byte for byte (the parameters section
    # is written from each booster's own config)
    trees = text.split("end of trees")[0]
    assert re.model_to_string().split("end of trees")[0] == trees
    np.testing.assert_array_equal(re.predict(X, raw_score=True), raw)
    with re.as_server(raw_score=True) as server:
        np.testing.assert_array_equal(server.predict(X), raw)
    scan = lgt.Booster(model_file=str(path),
                       params={**CPU, "predict_engine": "scan"})
    np.testing.assert_array_equal(scan.predict(X, raw_score=True), raw)
    # the JAX package reads the port's model text to the same raw scores
    jb = lgb.Booster(model_str=text, params={"tpu_fast_predict_rows": 0,
                                             "predict_engine": "scan"})
    np.testing.assert_allclose(jb.predict(X, raw_score=True), raw,
                               rtol=1e-6, atol=1e-6)


def test_training_scores_equal_model_predictions():
    """The device scores training accumulated (f32 leaf * shrinkage per
    tree) equal the saved model's raw predictions on the training rows —
    _finalize_tree's f32 rounding keeps them bit-for-bit."""
    X, y = _fused_data(seed=14)
    bst = lgt.train({"objective": "regression", "num_leaves": 15,
                     "verbose": -1, **CPU}, lgt.Dataset(X, label=y), 7)
    scores = bst._booster.scores[0].numpy()
    re = lgt.Booster(model_str=bst.model_to_string(),
                     params={**CPU, "predict_engine": "scan"})
    np.testing.assert_array_equal(re.predict(X.astype(np.float32),
                                             raw_score=True), scores)


def test_max_delta_step_matches_jax():
    """A cap that does not saturate (0.5 against leaf outputs of up to
    ~1.5 at learning rate 0.1): the training-row bar and equal leaf
    counts."""
    X, y = _fused_data()
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_delta_step": 0.5, "verbose": -1}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 8)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 8)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]


def test_saturated_max_delta_step_differs_from_jax_only_at_a_tie():
    """A cap of 0.05 clamps a leaf and both of its children to the same
    output, so such a split's gain equals its parent's in exact arithmetic
    and rounding decides whether it is taken (ROADMAP.md, Queue 3). The
    first tree (equal gradients on both sides) makes the same splits as
    JAX's up to the first pick where they part, and there both sides'
    gains are at the noise level of the root's gain."""
    X, y = _fused_data()
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_delta_step": 0.05, "verbose": -1}
    tj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y),
                   1)._booster.host_models[0]
    tt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y),
                   1)._booster.host_models[0]

    def picks(t):
        return [(t.split_feature[k], t.threshold_real[k], t.split_gain[k])
                for k in range(t.num_leaves - 1)]

    pj, pt = picks(tj), picks(tt)
    noise = 1e-6 * pj[0][2]
    k = 0
    while k < min(len(pj), len(pt)) and pj[k][:2] == pt[k][:2]:
        assert pj[k][2] == pytest.approx(pt[k][2], rel=1e-5)
        k += 1
    assert k >= 4, "the trees parted before the cap saturated"
    for side in (pj, pt):
        if k < len(side):
            assert side[k][2] < noise, (k, side[k])


def _cv_with(knob: str, value):
    """A refused cv argument."""
    def run(X, y):
        lgt.cv({"verbose": -1, **CPU},
               lgt.Dataset(X, label=y, free_raw_data=False), 2, nfold=2,
               **{knob: value})
    return run


LINEAR = {"verbose": -1, **CPU, "objective": "regression",
          "linear_tree": True, "num_leaves": 7}


def _linear_l1(X, y):
    """linear_tree under an objective that renews its leaves."""
    lgt.train({**LINEAR, "objective": "regression_l1"},
              lgt.Dataset(X, label=y), 2)


def _linear_rollback(X, y):
    lgt.train(LINEAR, lgt.Dataset(X, label=y), 2).rollback_one_iter()


def _linear_stream_binned(X, y):
    """predict_stream of a linear model over a binned source."""
    ds = lgt.Dataset(X, label=y)
    bst = lgt.train(LINEAR, ds, 2)
    bst.predict_stream(lgt.ShardedBinnedDataset.from_dataset(
        ds.construct(), 256))


def _linear_continued_by_dart(X, y):
    bst = lgt.train(LINEAR, lgt.Dataset(X, label=y), 2)
    lgt.train({"verbose": -1, **CPU, "objective": "regression",
               "boosting": "dart", "num_leaves": 7},
              lgt.Dataset(X, label=y, params={"linear_tree": True}), 2,
              init_model=bst)


def _fobj_n_by_k(X, y):
    """A 3-class fobj returning LightGBM 4's [N, K] gradient matrix."""
    bst = lgt.Booster(params={"verbose": -1, **CPU, "objective": "none",
                              "num_class": 3},
                      train_set=lgt.Dataset(X, label=np.round(y) % 3))
    bst.update(fobj=lambda p, d: (np.zeros((len(y), 3)),
                                  np.ones((len(y), 3))))


@pytest.mark.parametrize("params", [
    {"guard_faults": "nan_grad@2"},
    {"telemetry": True},
    {"timetag": True},
    {"telemetry_out": "run.jsonl"},
    {"profile_start_iter": 1},
    {"resume": "auto"},
    {"mesh_shape": "2x1"},
    {"enable_telemetry": True},
    {"tree_learner": "data"},
    {"boosting": "dart", "data_residency": "stream"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
     "data_residency": "stream"},
    {"tree_learner": "feature"},
    {"tree_learner": "voting"},
    {"snapshot_freq": 1},
    ("cv callbacks", _cv_with("callbacks", [lambda env: None]),
     NotImplementedError, "callbacks"),
    ("cv feval", _cv_with("feval", lambda p, d: ("m", 0.0, False)),
     NotImplementedError, "feval"),
    ("fobj [N, K]", _fobj_n_by_k, ValueError, r"shape \(\d+, 3\)"),
    ("linear_tree regression_l1", _linear_l1, RuntimeError,
     "regression_l1 objective with linear_tree"),
    ("linear rollback_one_iter", _linear_rollback, RuntimeError,
     "rollback_one_iter is not supported for linear_tree"),
    ("linear predict_stream binned", _linear_stream_binned, RuntimeError,
     "predict_stream: linear-leaf forests traverse raw rows"),
    ("linear init_model under dart", _linear_continued_by_dart,
     RuntimeError, "linear_tree model is only supported with boosting=gbdt"),
])
def test_unported_options_refuse_loudly(params, tmp_path):
    """Every option the port does not train, and a non-default value of
    every knob of a layer it does not carry, refuses by name; so do cv's
    arguments that the JAX package's cv ignores, a custom gradient in the
    [N, K] layout the JAX package would scramble, and what the JAX package
    refuses of linear leaves: an objective that renews its leaves,
    rollback, a binned predict_stream source, continuing under DART."""
    X, y = _fused_data(seed=15)
    if isinstance(params, tuple):
        _, run, exc, name = params
        with pytest.raises(exc, match=name):
            run(X, y)
        return
    knob = next(iter(params))
    with pytest.raises(NotImplementedError, match="not ported") as err:
        lgt.train({"verbose": -1, **CPU, **params},
                  lgt.Dataset(X, label=y), 2)
    name = {"timetag": "telemetry", "enable_telemetry": "telemetry"}.get(
        knob, knob)
    assert name in str(err.value)


def test_resume_auto_refuses_as_argument_and_as_knob():
    """``resume=auto`` resumes from a crash-safe snapshot in the JAX
    package; the port has no snapshots yet, so it refuses by name."""
    X, y = _fused_data(seed=15)
    with pytest.raises(NotImplementedError, match="resume=auto"):
        lgt.train({"verbose": -1, **CPU}, lgt.Dataset(X, label=y), 2,
                  resume="auto")
    with pytest.raises(NotImplementedError, match="resume=auto"):
        lgt.Booster(params={"verbose": -1, **CPU, "resume": "auto"},
                    train_set=lgt.Dataset(X, label=y))


def test_hist_precision_split_and_f32_are_k1s_exact_sums():
    """K1's sums are exact: ``split`` (the default) and ``f32`` train the
    same model, and ``bf16`` refuses by name."""
    X, y = _fused_data(seed=15)
    texts = {p: lgt.train({"verbose": -1, **CPU, "tpu_hist_precision": p},
                          lgt.Dataset(X, label=y), 3).model_to_string()
             for p in ("split", "f32")}
    body = {p: t.split("end of trees")[0] for p, t in texts.items()}
    assert body["split"] == body["f32"]
    with pytest.raises(NotImplementedError, match="tpu_hist_precision=bf16"):
        lgt.train({"verbose": -1, **CPU, "tpu_hist_precision": "bf16"},
                  lgt.Dataset(X, label=y), 1)


def test_tile_geometry_knobs_are_read_by_nothing():
    """``infer_row_block`` and ``tpu_rows_per_block`` set the JAX
    package's tiles; the port's kernels size their own, so neither moves a
    model or a prediction."""
    X, y = _fused_data(seed=15)
    out = []
    for rows in (256, 64):
        params = {"verbose": -1, **CPU, "infer_row_block": rows,
                  "tpu_rows_per_block": rows * 16}
        bst = lgt.train(params, lgt.Dataset(X, label=y), 3)
        out.append((bst.model_to_string().split("end of trees")[0],
                    bst.predict(X)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_booster_telemetry_refuses_by_name():
    X, y = _fused_data(seed=15)
    bst = lgt.train({"verbose": -1, **CPU}, lgt.Dataset(X, label=y), 1)
    with pytest.raises(NotImplementedError, match="Booster.telemetry"):
        bst.telemetry


def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_"))


@pytest.mark.parametrize("owner, name", sorted(
    [("Booster", n) for n in _public(lgb.Booster)]
    + [("Dataset", n) for n in _public(lgb.Dataset)]
    + [("module", n) for n in lgb.__all__]))
def test_every_public_jax_name_exists_or_refuses_by_name(owner, name):
    """Every public name of the JAX ``Booster``, ``Dataset`` and
    top-level module is in the port, or raises NotImplementedError naming
    itself: none is an AttributeError."""
    if owner == "module":
        try:
            getattr(lgt, name)
        except NotImplementedError as e:
            assert name in str(e)
        return
    port = getattr(lgt, owner)
    assert hasattr(port, name), f"{owner}.{name} is missing from the port"
    if owner == "Booster" and isinstance(getattr(port, name), property):
        X, y = _fused_data(seed=15)
        bst = lgt.Booster(params={"verbose": -1, **CPU},
                          train_set=lgt.Dataset(X, label=y))
        try:
            getattr(bst, name)
        except NotImplementedError as e:
            assert name in str(e)


@pytest.mark.parametrize("knob, value", [
    ("serve_trace_sample", 0.5), ("serve_trace_out", "spans.jsonl"),
    ("profile_serve_start_req", 3),
    ("serve_autonomics", True), ("serve_autonomics_placement", False)])
def test_unported_serve_knobs_refuse_loudly(knob, value):
    """A serve knob of a layer the port does not carry refuses by name in
    as_server; its default does not."""
    X, y = _fused_data(seed=16)
    bst = lgt.train({"verbose": -1, **CPU}, lgt.Dataset(X, label=y), 1)
    with bst.as_server() as server:
        server.predict(X[:3])
    bst.config = lgt.Config.from_params({**bst.params, knob: value})
    with pytest.raises(NotImplementedError, match=knob):
        bst.as_server()


def _node_rows(tree, binned):
    """Rows of ``binned`` reaching each internal node of ``tree`` (numerical
    splits without missing values)."""
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
    """The same split feature at every node, and thresholds equal up to
    bins that hold none of the node's training rows (an exact tie: both
    thresholds split the node's rows alike)."""
    assert tt.split_feature == tj.split_feature
    rows = _node_rows(tj, binned)
    for k in range(tj.num_leaves - 1):
        lo, hi = sorted((tj.threshold_bin[k], tt.threshold_bin[k]))
        b = binned[rows[k], tj.split_feature_inner[k]]
        assert not np.any((b > lo) & (b <= hi)), (k, lo, hi)


# (objective, num_grad_quant_bins, quant_train_renew_leaf,
# stochastic_rounding): each level count, renew on and off, stochastic
# rounding on and off, on both objectives
QUANT_CASES = [
    ("regression", 4, False, True), ("regression", 16, True, True),
    ("regression", 64, False, False), ("regression", 4, False, False),
    ("binary", 16, True, True), ("binary", 64, True, False),
    ("binary", 4, False, True), ("binary", 16, False, False),
]


@pytest.mark.parametrize("objective, qb, renew, stochastic", QUANT_CASES)
def test_quantized_training_matches_jax(objective, qb, renew, stochastic):
    """use_quantized_grad against the JAX fused learner: the same
    per-tree key, levels and exact level sums, so the training-row bar
    holds; leaf counts per tree equal."""
    X, y = _fused_data(seed=11)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 20, "verbose": -1,
              "use_quantized_grad": True, "num_grad_quant_bins": qb,
              "quant_train_renew_leaf": renew,
              "stochastic_rounding": stochastic}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 8)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 8)
    assert bt._booster.learner.quant
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]


@pytest.mark.parametrize("qb, renew", [(4, False), (16, False), (64, True)])
def test_deterministic_quantized_regression_splits_equal_jax(qb, renew):
    """The JAX package's quant-mode identity contract: with
    stochastic_rounding=false the split features of every tree equal
    JAX's, and every threshold equals JAX's up to bins that hold none of
    its node's training rows (an exact tie, broken by the last bits of
    either side's f32 scan)."""
    X, y = _fused_data(seed=11)
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 20, "verbose": -1,
              "use_quantized_grad": True, "num_grad_quant_bins": qb,
              "quant_train_renew_leaf": renew, "stochastic_rounding": False}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 8)
    dt = lgt.Dataset(X, label=y)
    bt = lgt.train({**params, **CPU}, dt, 8)
    binned = dt.construct().binned
    for tj, tt in zip(bj._booster.host_models, bt._booster.host_models):
        _assert_same_splits(tj, tt, binned)


def _discrete_data(seed, n=1500, d=6, levels=8):
    """Features with few distinct values: every bin of a leaf holds many
    rows, so no bin is empty of in-bag rows while holding out-of-bag ones
    (such a bin makes two thresholds an exact tie that routes the
    out-of-bag training rows differently; ROADMAP.md Queue 3)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, levels, (n, d)).astype(np.float64)
    z = X[:, 0] - 0.5 * X[:, 1] + np.sin(X[:, 2]) + 0.3 * rng.randn(n)
    return X, z


@pytest.mark.parametrize("objective, extra", [
    ("regression", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    ("regression", {"bagging_fraction": 0.6, "bagging_freq": 3,
                    "bagging_seed": 7}),
    ("binary", {"pos_bagging_fraction": 0.8, "neg_bagging_fraction": 0.4,
                "bagging_freq": 2}),
    ("regression", {"data_sample_strategy": "goss", "learning_rate": 0.3}),
    ("binary", {"data_sample_strategy": "goss", "learning_rate": 0.25,
                "top_rate": 0.3, "other_rate": 0.2}),
    ("binary", {"use_quantized_grad": True, "num_grad_quant_bins": 16,
                "bagging_fraction": 0.6, "bagging_freq": 1}),
])
def test_sampled_training_matches_jax(objective, extra):
    """Bagging, balanced bagging, GOSS past its warm-up, and quantized +
    bagging against the JAX fused learner: the same masks, amplified
    gradients and (under quantization) levels."""
    X, z = _discrete_data(seed=1)
    y = z if objective == "regression" else (z > z.mean()).astype(float)
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
              **extra}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 8)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 8)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert [t.num_leaves for t in bt._booster.host_models] == \
        [t.num_leaves for t in bj._booster.host_models]


def test_a_formed_bundle_trains_like_jax():
    """A one-hot-like table on which EFB forms a bundle trains over the
    bundled columns, to the JAX package's model."""
    rng = np.random.RandomState(17)
    which = rng.randint(0, 6, 2000)
    X = np.zeros((2000, 6))
    X[np.arange(2000), which] = rng.rand(2000) + 0.5
    y = X.sum(1) * (1 + which % 3) + rng.randn(2000) * 0.1
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 6)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 6)
    assert bt._booster.learner.x_rows.shape[1] < 6
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_quantized_level_sums_that_could_overflow_refuse_loudly():
    """rows x num_grad_quant_bins at or past int32 max: the per-chunk
    float32 fallback is not ported, so the learner refuses, naming the
    knob."""
    from lambdagap_tpu_torch.models.fused_learner import FusedTreeLearner
    X, y = _fused_data(seed=19)
    ds = lgt.Dataset(X, label=y).construct()
    ds.num_data = 2**31 // 64          # the learner reads the row count
    cfg = lgt.Config.from_params({**CPU, "use_quantized_grad": True,
                                  "num_grad_quant_bins": 64})
    with pytest.raises(NotImplementedError, match="num_grad_quant_bins"):
        FusedTreeLearner(ds, cfg, torch.device("cpu"))


def test_training_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default trains on it")
    X, y = _fused_data(seed=18)
    with pytest.raises(RuntimeError, match="device_type=cpu"):
        lgt.train({"verbose": -1}, lgt.Dataset(X, label=y), 1)
