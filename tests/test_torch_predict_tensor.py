"""The port's tensor engine and ``pred_leaf`` against the JAX package.

``predict_engine=tensor`` (``lambdagap_tpu_torch/ops/predict_tensor.py``)
must give raw scores ``array_equal`` to the JAX package's
``predict_forest_tensor`` on the same stacked forest, and to the port's
scan oracle and compiled engine: several tiles with a padded tail
(``predict_tree_tile=7``), NaN / zero-missing / default-left routing,
categorical bitsets past one word with hostile values, binned rows,
multiclass and early stop. ``pred_leaf`` is ``array_equal`` to the JAX
package's on every engine (under ``compiled`` it reads the traversal
kernel's carry), and a tensor-engine booster serves exactly what it
predicts.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.ops.predict import forest_to_arrays as jax_forest_arrays
from lambdagap_tpu.ops.predict_tensor import \
    predict_forest_tensor as jax_predict_tensor
from lambdagap_tpu_torch.convert import booster_from_numpy, trees_from_numpy
from lambdagap_tpu_torch.convert import tree_fields
from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
from lambdagap_tpu_torch.models import synth
from lambdagap_tpu_torch.ops.predict import (TreeArrays, build_forest_blocks,
                                             forest_to_arrays, predict_forest,
                                             predict_forest_leaf,
                                             predict_leaf_index_binned)
from lambdagap_tpu_torch.ops.predict_tensor import (
    predict_forest_leaf_tensor, predict_forest_tensor)

CPU = {"device_type": "cpu"}
TILE = 7
# (trees, features, classes, early-stop freq in trees, margin)
CASES = {
    "numeric": (lambda: synth.random_trees(1, 23, 31, 10, grid_size=40),
                10, 1, 0, 0.0),
    "categorical": (lambda: synth.categorical_trees(2, num_trees=17),
                    6, 1, 0, 0.0),
    "binary_early_stop": (lambda: synth.random_trees(4, 23, 31, 10,
                                                     grid_size=40),
                          10, 1, 4, 0.05),
    "multiclass_early_stop": (lambda: synth.random_trees(5, 24, 15, 8,
                                                         grid_size=30),
                              8, 3, 6, 0.05),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port booster, JAX trees, rows, classes, es freq, margin), both
    parsed from one model text."""
    make, feats, K, freq, margin = CASES[name]
    objective = ("binary sigmoid:1" if K == 1
                 else f"multiclass num_class:{K}")
    text = booster_from_numpy(synth.header(feats, objective), make(),
                              CPU).model_to_string()
    port = lgt.Booster(model_str=text, params=CPU)._booster
    ref = lgb.Booster(model_str=text)._booster.models
    rng = np.random.RandomState(7)
    rows = (synth.hostile_rows(rng, 300, feats) if name == "categorical"
            else synth.random_rows(rng, 300, feats))
    return port, ref, rows, K, freq, margin


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_engine_equals_jax_scan_and_compiled(name):
    gb, ref, X, K, freq, margin = _case(name)
    port = gb.models
    tc = [i % K for i in range(len(port))]
    jf, jdepth = jax_forest_arrays(ref)
    want = np.asarray(jax_predict_tensor(
        jnp.asarray(X), jf, jnp.asarray(tc, jnp.int32), K, jdepth, False,
        freq, margin, tree_tile=TILE))
    forest, depth = forest_to_arrays(port, device=torch.device("cpu"))
    assert depth == jdepth
    x = torch.from_numpy(X)
    got = predict_forest_tensor(x, forest, tc, K, depth, False, freq, margin,
                                tree_tile=TILE).numpy()
    scan = predict_forest(x, forest, tc, K, depth, freq, margin).numpy()
    blocked = predict_forest(x, forest, tc, K, depth, freq, margin,
                             blocks=build_forest_blocks(forest, tc,
                                                        TILE)).numpy()
    compiled = CompiledForest(compile_forest(gb), torch.device("cpu"),
                              early_stop_freq=freq,
                              early_stop_margin=margin).predict(x).numpy()
    assert got.shape == (K, len(X))
    for other in (want, scan, blocked, compiled):
        assert np.array_equal(got, other)
    if freq:
        full = predict_forest_tensor(x, forest, tc, K, depth,
                                     tree_tile=TILE).numpy()
        assert not np.array_equal(full, got)     # some rows stopped


@pytest.mark.parametrize("name", ["numeric", "categorical"])
def test_leaf_dispatch_equals_jax_on_every_tile_layout(name):
    gb, _ref, X, _K, _f, _m = _case(name)
    port = gb.models
    want = lgb.Booster(model_str=gb.save_model_to_string(),
                       params={"predict_engine": "scan"}).predict(
        X, pred_leaf=True)
    forest, depth = forest_to_arrays(port, device=torch.device("cpu"))
    x = torch.from_numpy(X)
    for got in (predict_forest_leaf_tensor(x, forest, depth, tree_tile=TILE),
                predict_forest_leaf_tensor(x, forest, depth, tree_tile=64),
                predict_forest_leaf(x, forest, depth, tree_block=TILE)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().T, want)


@functools.lru_cache(maxsize=None)
def _trained():
    """A JAX-trained binary model with NaN / zero-missing features and a
    12-category column, and its training Dataset."""
    rng = np.random.RandomState(0)
    X = rng.randn(700, 6)
    X[:, 0] = rng.randint(0, 12, 700)
    X[::7, 2] = np.nan
    X[::5, 3] = 0.0
    y = ((X[:, 0] % 3 == 0) ^ (X[:, 1] > 0.3)).astype(float)
    ds = lgb.Dataset(X, label=y, categorical_feature=[0],
                     params={"verbose": -1})
    bst = lgb.train({"verbose": -1, "objective": "binary", "num_leaves": 15,
                     "min_data_in_leaf": 5, "tpu_fast_predict_rows": 0,
                     "zero_as_missing": False}, ds, 9)
    return bst, X


def test_tensor_engine_binned_equals_jax():
    bst, _X = _trained()
    gb = bst._booster
    trees = gb.host_models
    ds = gb.train_set
    meta = ds.feature_arrays()
    jf, depth = jax_forest_arrays(trees, feature_meta=meta,
                                  use_inner_feature=True)
    tc = [0] * len(trees)
    want = np.asarray(jax_predict_tensor(
        jnp.asarray(ds.binned), jf, jnp.asarray(tc, jnp.int32), 1, depth,
        True, tree_tile=4))
    port = trees_from_numpy([tree_fields(t) for t in trees])
    forest, pdepth = forest_to_arrays(port, feature_meta=meta,
                                      use_inner_feature=True,
                                      device=torch.device("cpu"))
    xb = torch.from_numpy(np.ascontiguousarray(ds.binned))
    got = predict_forest_tensor(xb, forest, tc, 1, pdepth, True,
                                tree_tile=4).numpy()
    scan = predict_forest(xb, forest, tc, 1, pdepth, binned=True).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, scan)
    leaves = predict_forest_leaf_tensor(xb, forest, pdepth, binned=True,
                                        tree_tile=4)
    assert np.array_equal(leaves.numpy(),
                          predict_forest_leaf(xb, forest, pdepth,
                                              binned=True).numpy())
    one = TreeArrays(*(a[3] for a in forest))
    assert np.array_equal(
        predict_leaf_index_binned(xb, one, pdepth).numpy(), leaves[3].numpy())


@pytest.mark.parametrize("engine", ["compiled", "tensor", "scan"])
def test_pred_leaf_equals_jax_on_every_engine(engine):
    bst, X = _trained()
    port = lgt.Booster(model_str=bst.model_to_string(), params={
        "device_type": "cpu", "predict_engine": engine,
        "predict_tree_tile": 4})
    want = bst.predict(X, pred_leaf=True)
    got = port.predict(X, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    sl = port.predict(X, pred_leaf=True, start_iteration=2, num_iteration=3)
    assert np.array_equal(sl, bst.predict(X, pred_leaf=True,
                                          start_iteration=2,
                                          num_iteration=3))


def test_predict_engine_tensor_predicts_and_serves():
    """``predict_engine=tensor`` is accepted (the port's default stays
    ``compiled``), predicts the JAX package's raw scores and serves them
    bit for bit."""
    bst, X = _trained()
    assert lgt.Config().predict_engine == "compiled"
    port = lgt.Booster(model_str=bst.model_to_string(), params={
        "device_type": "cpu", "predict_engine": "tensor",
        "predict_tree_tile": 4})
    raw = port.predict(X, raw_score=True)
    assert np.array_equal(raw, bst.predict(X, raw_score=True))
    with port.as_server(raw_score=True) as server:
        assert server.cache.engine == "tensor"
        assert np.array_equal(server.predict(X), raw)
