"""Piece-wise linear leaves (``linear_tree``) on the CPU, held to the JAX
package on the same numpy inputs (``tests/test_linear.py``'s sizes: 1,200
rows x 5 features, 6 leaves).

Trained models: the port's fused and serial learners give byte-equal trees
(one moment pass and one solve over the same row -> leaf map), and their
predictions on the training rows equal the JAX package's fused learner's
at rtol 1e-4 / atol 1e-5 (the moments are f32 sums taken in another order,
so the float64 solve's coefficients part in the last bits). The functions:
the moments at rtol 1e-5 against the JAX function on the same rows and
map, the float64 solve equal on equal moments, the per-row outputs at
rtol 1e-12 (float64 dot products in another order). The engines (scan,
tensor and the fused kernel's plain version) are ``array_equal`` to one
another on linear and mixed forests; against the JAX package's engines a
model's raw scores part by rounding only (XLA contracts ``const + c * x``
into fused multiply-adds; the port rounds each step). The API cases:
``pred_contrib`` with NaN rows, ``init_model`` from a JAX-written linear
model text, a late validation set, refit, the quantized and streamed
fallbacks, packed serving, ``predict_stream``, the guard, the compiled
artifact and the numpy conversion.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import copy
import functools
import logging

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.infer import compile_forest as jax_compile
from lambdagap_tpu.models import gbdt as jax_gbdt
from lambdagap_tpu.models import model_text as jax_text
from lambdagap_tpu.ops import linear as jax_linear
from lambdagap_tpu.serve.delta import split_model_text as jax_split
from lambdagap_tpu_torch.convert import (booster_from_numpy, tree_fields,
                                         trees_from_numpy)
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.models import gbdt as port_gbdt
from lambdagap_tpu_torch.models import model_text as port_text
from lambdagap_tpu_torch.models.linear_leaf import leaf_path_features
from lambdagap_tpu_torch.models.tree import linear_leaf_outputs
from lambdagap_tpu_torch.ops import linear as port_linear
from lambdagap_tpu_torch.serve.delta import split_model_text

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
BASE = {"objective": "regression", "num_leaves": 6, "learning_rate": 0.4,
        "min_data_in_leaf": 20, "verbose": -1, "linear_tree": True,
        "linear_lambda": 1e-3}
BAR = {"rtol": 1e-4, "atol": 1e-5}


def _data(n=1200, seed=5, nan=False, cat=False):
    """tests/test_linear.py's data."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(n, 5) * 4).astype(np.float32)
    if cat:
        X[:, 4] = rng.randint(0, 6, n)
    if nan:
        X[::13, 0] = np.nan
        X[::29, 2] = np.nan
    base = np.nan_to_num(X, nan=1.0)
    y = (2.0 * base[:, 0] - 1.5 * base[:, 1]
         + np.where(base[:, 2] > 2, 3.0, 0.0)
         + (base[:, 4] % 3 if cat else 0.0)
         + 0.05 * rng.randn(n)).astype(np.float32)
    return X, y


def _trees(booster) -> str:
    return booster.model_to_string().split("end of trees")[0]


def _blocks(text: str, split=split_model_text) -> str:
    return "".join(split(text)[1])


@functools.lru_cache(maxsize=None)
def _jax_model(nan=True, rounds=6):
    """A JAX-trained linear model's text and its training rows."""
    X, y = _data(nan=nan)
    b = lgb.train({**BASE, **JAX_F32}, lgb.Dataset(X, label=y), rounds)
    return b.model_to_string(), X, y


# -- training: fused == serial, both held to the JAX package -------------
@pytest.mark.parametrize("extra", [
    {},
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"data_sample_strategy": "goss", "top_rate": 0.3, "other_rate": 0.2},
    {"_nan": True},
    {"_cat": True},
    {"max_depth": 3, "lambda_l2": 1.0},
    {"boost_from_average": False, "_nan": True},
])
def test_linear_trees_match_jax_on_both_learners(extra):
    ex = dict(extra)
    nan, cat = ex.pop("_nan", False), ex.pop("_cat", False)
    X, y = _data(nan=nan, cat=cat)
    cats = [4] if cat else "auto"
    params = {**BASE, **ex}
    bj = lgb.train({**params, **JAX_F32},
                   lgb.Dataset(X, label=y, categorical_feature=cats), 6)
    out = {}
    for fused in ("1", "0"):
        out[fused] = lgt.train(
            {**params, **CPU, "tpu_fused_learner": fused},
            lgt.Dataset(X, label=y, categorical_feature=cats), 6)
    assert out["0"]._booster.serial and not out["1"]._booster.serial
    assert _trees(out["1"]) == _trees(out["0"])
    models = out["1"]._booster.host_models
    assert all(t.is_linear for t in models)
    assert any(len(f) for t in models for f in t.leaf_features)
    np.testing.assert_allclose(out["1"].predict(X), bj.predict(X), **BAR)
    # the booster's training scores are its predictions on those rows
    np.testing.assert_allclose(out["1"]._booster.scores[0].numpy(),
                               out["1"].predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-6)


# -- the two repairs: shrinkage and the boost-from-average bias -----------
def _tree_pair():
    """The first linear tree of a JAX model, parsed by each package."""
    text, _, _ = _jax_model()
    block = jax_split(text)[1][0]
    body = block.split("\n", 1)[1]
    return jax_text.tree_from_string(body), port_text.tree_from_string(body)


def test_shrinkage_scales_the_linear_payload_like_jax():
    tj, tp = _tree_pair()
    assert tp.is_linear and any(len(c) for c in tp.leaf_coeff)
    before = port_text.tree_to_string(tp)
    tj.apply_shrinkage(0.37)
    tp.apply_shrinkage(0.37)
    assert port_text.tree_to_string(tp) == jax_text.tree_to_string(tj)
    assert port_text.tree_to_string(tp) != before


def test_bias_goes_into_leaf_const_like_jax():
    tj, tp = _tree_pair()
    jax_gbdt.GBDT._tree_add_bias(None, tj, 0.625, 0)
    port_gbdt._add_bias(tp, 0.625)
    assert port_text.tree_to_string(tp) == jax_text.tree_to_string(tj)
    tj, tp = _tree_pair()
    jax_gbdt._finalize_tree(tj, 0.3, -1.25)
    port_gbdt._finalize_tree(tp, 0.3, -1.25)
    assert port_text.tree_to_string(tp) == jax_text.tree_to_string(tj)


# -- the functions against the JAX package's -------------------------------
def _moment_inputs(seed=2, n=3000, D=7, L=9, FL=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    X[rng.rand(n, D) < 0.03] = np.nan
    leaf = rng.randint(0, L, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    h[rng.rand(n) < 0.2] = 0.0           # out-of-bag rows
    tbl = np.full((L + 1, FL), -1, np.int32)
    for i in range(L):
        k = rng.randint(0, D + 1)
        tbl[i, :k] = np.sort(rng.choice(D, k, replace=False))
    return X, leaf, g, h, tbl


def test_moments_and_solve_match_jax():
    X, leaf, g, h, tbl = _moment_inputs()
    L = tbl.shape[0] - 1
    want = [np.asarray(a) for a in jax_linear.accumulate_leaf_moments(
        X, leaf, g, h, tbl, num_leaves=L, chunk=256)]
    got = [a.numpy() for a in port_linear.accumulate_leaf_moments(
        torch.from_numpy(X), torch.from_numpy(leaf), torch.from_numpy(g),
        torch.from_numpy(h), tbl, L)]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    assert np.array_equal(got[2], want[2])      # counts exactly
    nfeat = (tbl[:L] >= 0).sum(1).astype(np.int64)
    for lam in (1e-3, 0.0):
        sp, okp = port_linear.solve_linear_leaves(*(w[:L] for w in want),
                                                  nfeat, lam)
        sj, okj = jax_linear.solve_linear_leaves(*(w[:L] for w in want),
                                                 nfeat, lam)
        assert np.array_equal(okp, okj) and np.array_equal(sp, sj)
        # the port's own moments through the solve: coefficients close
        sg, okg = port_linear.solve_linear_leaves(*(a[:L] for a in got),
                                                  nfeat, lam)
        assert np.array_equal(okg, okj)
        np.testing.assert_allclose(sg[okg], sj[okj], rtol=1e-4, atol=1e-6)


def test_moments_do_not_depend_on_chunking(monkeypatch):
    X, leaf, g, h, tbl = _moment_inputs(seed=4)
    args = (torch.from_numpy(X), torch.from_numpy(leaf), torch.from_numpy(g),
            torch.from_numpy(h), tbl, tbl.shape[0] - 1)
    whole = port_linear.accumulate_leaf_moments(*args)
    monkeypatch.setattr(port_linear, "MOMENT_ROWS", 700)
    chunked = port_linear.accumulate_leaf_moments(*args)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(whole[2], chunked[2])


def test_leaf_outputs_match_jax():
    from lambdagap_tpu.models.tree import linear_leaf_outputs as jax_out
    text, X, _ = _jax_model()
    jb = lgb.Booster(model_str=text)
    pb = lgt.Booster(model_str=text, params=CPU)
    leaf = pb.predict(X, pred_leaf=True)
    for i, (tj, tp) in enumerate(zip(jb._booster.host_models,
                                     pb._booster.models)):
        want = jax_out(tj, X, leaf[:, i])
        got = linear_leaf_outputs(tp, torch.from_numpy(X),
                                  torch.from_numpy(leaf[:, i])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert np.array_equal(np.isnan(got), np.isnan(want))


def test_leaf_path_features_match_jax():
    from lambdagap_tpu.models.linear_leaf import \
        leaf_path_features as jax_paths
    tj, tp = _tree_pair()
    mask = np.array([True, True, False, True, True])
    assert np.array_equal(leaf_path_features(tp, mask, 6, 8),
                          jax_paths(tj, mask, 6, 8))


def _mixed_booster():
    """A port booster whose forest is 4 linear trees then 4 constant ones
    (the shape a constant continuation of a linear model has)."""
    X, y = _data(nan=True)
    lin = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 4)
    const = lgt.train({k: v for k, v in {**BASE, **CPU}.items()
                       if k != "linear_tree"}, lgt.Dataset(X, label=y), 4)
    gb = lin._booster
    gb.models = list(gb.host_models) + list(const._booster.host_models)
    gb.iter_ = len(gb.models)
    gb.invalidate_predict_cache()
    return lin, X


@pytest.mark.parametrize("forest", ["linear", "mixed"])
def test_engines_array_equal_on_linear_forests(forest):
    if forest == "mixed":
        b, X = _mixed_booster()
        text = b.model_to_string()
    else:
        text, X, _ = _jax_model()
    assert compile_forest(lgt.Booster(model_str=text, params=CPU)._booster
                          ).meta["has_linear"]
    outs = {}
    for eng in ("compiled", "tensor", "scan"):
        bb = lgt.Booster(model_str=text, params={**CPU,
                                                 "predict_engine": eng,
                                                 "predict_tree_tile": 3})
        outs[eng] = [bb.predict(X[:n], raw_score=True)
                     for n in (1, 37, 257, len(X))]
    for eng in ("compiled", "tensor"):
        for a, c in zip(outs[eng], outs["scan"]):
            assert np.array_equal(a, c), eng
    assert np.isfinite(outs["scan"][-1]).all()
    want = lgb.Booster(model_str=text, params={
        "predict_engine": "compiled", "tpu_fast_predict_rows": 0,
        "verbose": -1}).predict(X, raw_score=True)
    np.testing.assert_allclose(outs["scan"][-1], want, rtol=1e-6, atol=1e-6)


def test_linear_leaf_values_match_jax():
    text, X, _ = _jax_model()
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    from lambdagap_tpu_torch.ops.predict import forest_to_arrays
    f, _ = forest_to_arrays(gb.models)
    T, L = f.leaf_value.shape
    FL = f.leaf_feat.shape[-1]
    rng = np.random.RandomState(0)
    flat = (np.arange(T) * L + rng.randint(0, 6, (len(X), T))).astype(
        np.int32)
    tabs = (f.leaf_value.reshape(-1), f.leaf_const.reshape(-1),
            f.leaf_feat.reshape(-1, FL), f.leaf_coeff.reshape(-1, FL))
    got = port_linear.linear_leaf_values(
        torch.from_numpy(X), torch.from_numpy(flat),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in tabs)).numpy()
    import jax.numpy as jnp
    want = np.asarray(jax_linear.linear_leaf_values(
        jnp.asarray(X), jnp.asarray(flat), *(jnp.asarray(a) for a in tabs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))


# -- the API ----------------------------------------------------------------
def test_pred_contrib_sums_to_raw_scores_with_nans():
    text, X, _ = _jax_model()
    pb = lgt.Booster(model_str=text, params=CPU)
    phi = pb.predict(X, pred_contrib=True)
    assert phi.shape == (len(X), X.shape[1] + 1)
    np.testing.assert_allclose(phi.sum(axis=1), pb.predict(X,
                                                           raw_score=True),
                               rtol=1e-5, atol=1e-6)
    want = lgb.Booster(model_str=text).predict(X, pred_contrib=True)
    np.testing.assert_allclose(phi, want, rtol=1e-9, atol=1e-12)
    # the NaN rows' fallbacks land on a feature of theirs, not the bias
    nan_rows = np.isnan(X).any(1)
    assert nan_rows.any()


def test_init_model_continues_a_jax_written_linear_model(tmp_path):
    text, X, y = _jax_model(rounds=4)
    port = lgt.Booster(model_str=text, params=CPU)
    assert _blocks(port.model_to_string()) == _blocks(text, jax_split)
    path = tmp_path / "jax_linear.txt"
    path.write_text(text)
    bt = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 3,
                   init_model=str(path))
    bj = lgb.train({**BASE, **JAX_F32}, lgb.Dataset(X, label=y), 3,
                   init_model=lgb.Booster(model_str=text))
    assert bt.num_trees() == bj.num_trees() == 7
    assert _blocks(bt.model_to_string())[:len(_blocks(text, jax_split))] \
        == _blocks(text, jax_split)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), **BAR)


def test_init_model_keeps_raw_rows_through_the_datasets_own_params():
    """A constant continuation of a linear model: the booster's params
    lack linear_tree, the Dataset's own params keep its raw matrix."""
    X, y = _data(900, seed=11)
    b5 = lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 5)
    const = {k: v for k, v in {**BASE, **CPU}.items()
             if k not in ("linear_tree", "linear_lambda")}
    ds = lgt.Dataset(X, label=y, params={"linear_tree": True})
    resumed = lgt.train(const, ds, 3, init_model=b5)
    assert resumed.num_trees() == 8
    assert not resumed._booster.host_models[-1].is_linear
    # the replay gave the scores the linear model predicts
    base = lgt.train(const, lgt.Dataset(X, label=y, params={
        "linear_tree": True}), 0, init_model=b5)
    np.testing.assert_allclose(base._booster.scores[0].numpy(),
                               b5.predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="raw"):
        lgt.train(const, lgt.Dataset(X, label=y), 2, init_model=b5)


def test_a_late_validation_set_replays_the_incremental_scores():
    X, y = _data(nan=True)
    Xv, yv = _data(400, seed=9, nan=True)
    tr = lgt.Dataset(X, label=y)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    bst = lgt.train({**BASE, **CPU}, tr, 5, valid_sets=[va])
    gb = bst._booster
    assert va.construct().raw is not None
    bst.add_valid(lgt.Dataset(Xv, label=yv, reference=tr), "late")
    torch.testing.assert_close(gb.valid_scores[1], gb.valid_scores[0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bst.predict(Xv, raw_score=True),
                               gb.valid_scores[0][0].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_refit_drops_the_linear_payload_like_jax():
    text, X, y = _jax_model()
    pb = lgt.Booster(model_str=text, params=CPU)
    jb = lgb.Booster(model_str=text)
    rp = pb.refit(X, y)
    rj = jb.refit(X, y)
    assert not any(t.is_linear for t in rp._booster.host_models)
    np.testing.assert_allclose(rp.predict(X), rj.predict(X), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("knob,word", [
    ({"use_quantized_grad": True}, "use_quantized_grad"),
    ({"data_residency": "stream"}, "data_residency=stream")])
def test_quantized_and_stream_fall_back_with_the_jax_warning(knob, word,
                                                             caplog):
    X, y = _data()
    with caplog.at_level(logging.WARNING, logger="lambdagap_tpu_torch"):
        b = lgt.train({**BASE, **CPU, **knob, "verbose": 0,
                       "tpu_fused_learner": "1"},
                      lgt.Dataset(X, label=y), 3)
    assert any(word in r.getMessage() for r in caplog.records)
    gb = b._booster
    assert gb.learner.residency == "hbm" and not gb.config.use_quantized_grad
    assert all(t.is_linear for t in gb.host_models)


def test_packed_serving_of_a_linear_and_a_constant_model():
    text, X, y = _jax_model()
    const = lgt.train({k: v for k, v in {**BASE, **CPU}.items()
                       if k != "linear_tree"}, lgt.Dataset(X, label=y), 4)
    bst = lgt.Booster(model_str=text, params={**CPU,
                                              "serve_pack_models": True})
    s = bst.as_server(buckets=(8, 32), warmup=False, max_delay_ms=200.0,
                      workers=1, raw_score=True)
    try:
        s.add_model("const", const.model_to_string())
        before = s.stats_snapshot()["cache"]["packed_dispatches"]
        futs = [s.submit(X[:13]), s.submit(X[13:30], model="const")]
        outs = [f.result(60) for f in futs]
        assert s.stats_snapshot()["cache"]["packed_dispatches"] == before + 1
        assert np.array_equal(outs[0].values, bst.predict(X[:13],
                                                          raw_score=True))
        assert np.array_equal(outs[1].values, const.predict(
            X[13:30], raw_score=True))
    finally:
        s.close()


def test_predict_stream_of_a_linear_model(tmp_path):
    text, X, _ = _jax_model()
    bst = lgt.Booster(model_str=text, params=CPU)
    mm = np.lib.format.open_memmap(str(tmp_path / "rows.npy"), mode="w+",
                                   dtype=np.float32, shape=X.shape)
    mm[:] = X
    mm.flush()
    for src in (X, np.load(str(tmp_path / "rows.npy"), mmap_mode="r")):
        assert np.array_equal(bst.predict_stream(src, window_rows=256),
                              bst.predict(X))
        assert np.array_equal(bst.predict_stream(src, raw_score=True,
                                                 window_rows=300),
                              bst.predict(X, raw_score=True))
    np.testing.assert_allclose(
        bst.predict_stream(X, pred_contrib=True, window_rows=512),
        bst.predict(X.astype(np.float32), pred_contrib=True), rtol=0,
        atol=0)


def test_skip_tree_restores_a_linear_round_like_jax():
    """tests/test_torch_guard.py's poisson run, whose exp overflows from
    round 1, with linear leaves. Its first tree parts from the JAX
    package's by ~1e-6 relative (f32 sums of poisson's large hessians in
    another order); the ridge (linear_lambda 10) keeps the leaf solves
    conditioned so that stays within the bar."""
    rng = np.random.RandomState(3)
    X = rng.randn(1000, 6)
    y = np.exp(X[:, 0] * 2 + X[:, 1]) * rng.poisson(1.0, 1000)
    params = {"objective": "poisson", "num_leaves": 7, "learning_rate": 2.9,
              "min_data_in_leaf": 20, "verbose": -1, "linear_tree": True,
              "linear_lambda": 10.0, "guard_nonfinite": "skip_tree"}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 4)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 4)
    gt = bt._booster
    assert len(gt.models) == len(bj._booster.models) == 1
    assert gt.last_iteration_skipped and gt.host_models[0].is_linear
    assert np.isfinite(gt.scores.numpy()).all()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), **BAR)
    # a late find: the scores a linear round left are restored, the round
    # regrown (a deterministic run regrows the same tree)
    Xr, yr = _data()
    bst = lgt.train({**BASE, **CPU, "guard_nonfinite": "skip_tree"},
                    lgt.Dataset(Xr, label=yr), 3)
    clean = bst.predict(Xr, raw_score=True)
    bst._booster.scores[0, 5] = float("inf")
    bst._booster.guard._unchecked = True
    assert bst.update() is False
    assert len(bst._booster.models) == 3
    np.testing.assert_array_equal(bst.predict(Xr, raw_score=True), clean)


def test_compiled_artifact_equals_jax_artifact():
    text, _, _ = _jax_model()
    ref = jax_compile(lgb.Booster(model_str=text)._booster)
    port = compile_forest(lgt.Booster(model_str=text, params=CPU)._booster)
    assert ref.meta["has_linear"] and port.meta == ref.meta
    assert sorted(port.buffers) == sorted(ref.buffers)
    for k in ref.buffers:
        assert port.buffers[k].dtype == ref.buffers[k].dtype, k
        assert np.array_equal(port.buffers[k], ref.buffers[k]), k
    assert port.hash == ref.hash and port.to_bytes() == ref.to_bytes()


def test_numpy_conversion_of_a_jax_trained_linear_forest():
    text, X, _ = _jax_model()
    jb = lgb.Booster(model_str=text)
    by_text = lgt.Booster(model_str=text, params=CPU)
    from lambdagap_tpu_torch.models.model_text import load_model_from_string
    header, _ = load_model_from_string(text)
    trees = trees_from_numpy([tree_fields(t)
                              for t in jb._booster.host_models])
    assert all(t.is_linear for t in trees)
    by_numpy = booster_from_numpy(header, trees, params=CPU)
    assert by_numpy.model_to_string() == by_text.model_to_string()
    assert _blocks(by_numpy.model_to_string()) == _blocks(text, jax_split)
    assert np.array_equal(by_numpy.predict(X, raw_score=True),
                          by_text.predict(X, raw_score=True))


def test_copies_do_not_share_the_linear_payload():
    """resume_from deep-copies the caller's trees: continuing does not
    touch the init model's payload."""
    text, X, y = _jax_model(rounds=4)
    init = lgt.Booster(model_str=text, params=CPU)
    before = copy.deepcopy([t.leaf_coeff for t in init._booster.models])
    lgt.train({**BASE, **CPU}, lgt.Dataset(X, label=y), 1, init_model=init)
    after = [t.leaf_coeff for t in init._booster.models]
    assert all(np.array_equal(a, b) for ta, tb in zip(before, after)
               for a, b in zip(ta, tb))
