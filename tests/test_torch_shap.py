"""``pred_contrib`` (TreeSHAP) of the port against the JAX package.

The port's path-form TreeSHAP (``lambdagap_tpu_torch/models/shap.py``; on
the CPU its plain version) must match the JAX package's
``predict_contrib`` (the native unique-path recursion) at rtol 1e-9 /
atol 1e-12 — the bar the JAX package holds its own fallback to
(``tests/test_shap_json.py``) — on a JAX-trained binary model with a
categorical column, NaN cells and zero as missing and on a multiclass
one, both loaded through their text, and on synthetic forests with
hostile categorical values; rows sum to the raw scores (rtol 1e-5 /
atol 1e-6), and a feature no tree splits on gets exactly 0. The path tables merge repeated features, chunking does not
change the values, and a path longer than the kernel's cap is refused by
name.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.models.shap import tree_shap_accumulate
from lambdagap_tpu_torch.convert import booster_from_numpy
from lambdagap_tpu_torch.models import shap, synth
from lambdagap_tpu_torch.models.tree import Tree

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-9, 1e-12


@functools.lru_cache(maxsize=None)
def _model(kind):
    """(JAX booster, rows): trained on 700 rows of 7 features; feature 6
    is constant, so no tree splits on it. The binary model has a
    40-category column (bitset splits), NaN cells and zero as missing."""
    rng = np.random.RandomState(11)
    X = rng.randn(700, 7)
    p = {"verbose": -1, "num_leaves": 15, "min_data_in_leaf": 5,
         "tpu_fast_predict_rows": 0}
    cats = "auto"
    if kind == "binary":
        X[rng.rand(700, 7) < 0.1] = np.nan
        X[::9, 3] = 0.0
        X[:, 0] = rng.randint(0, 40, 700)
        y = ((X[:, 0] % 4 == 1) | (np.nan_to_num(X[:, 1]) > 1.0)
             | np.isnan(X[:, 2])).astype(float)
        cats = [0]
        p.update(objective="binary", zero_as_missing=True,
                 max_cat_to_onehot=4)
    else:
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclass", num_class=3)
    X[:, 6] = 1.0
    bst = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=cats), 8)
    return bst, X


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_contrib_equals_jax(kind):
    bst, X = _model(kind)
    if kind == "binary":
        trees = bst._booster.host_models
        assert any(any(t.is_categorical[:t.num_internal]) for t in trees)
    port = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    want = bst.predict(X, pred_contrib=True)
    got = port.predict(X, pred_contrib=True)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    K = port.num_model_per_iteration()
    F = X.shape[1]
    phi = got.reshape(len(X), K, F + 1)
    raw = port.predict(X, raw_score=True).reshape(len(X), K)
    np.testing.assert_allclose(phi.sum(axis=2), raw, rtol=1e-5, atol=1e-6)
    assert (phi[:, :, 6] == 0.0).all()


def test_pred_contrib_slice_equals_jax():
    bst, X = _model("multiclass")
    port = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    got = port.predict(X[:50], pred_contrib=True, start_iteration=2,
                       num_iteration=3)
    want = bst.predict(X[:50], pred_contrib=True, start_iteration=2,
                       num_iteration=3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_plain_version_equals_native_recursion_on_synthetic_forests(kind):
    """Hostile categorical values (saturating magnitudes, negatives,
    fractions, NaN, past the bitset) and every missing type, tree by tree
    against ``lg_tree_shap``."""
    if kind == "numeric":
        trees, feats = synth.random_trees(6, 6, 63, 5, grid_size=20), 5
    else:
        trees, feats = synth.categorical_trees(7, num_trees=6), 6
    text = booster_from_numpy(synth.header(feats), trees,
                              CPU).model_to_string()
    ref = lgb.Booster(model_str=text)._booster.models
    rng = np.random.RandomState(5)
    X = (synth.hostile_rows(rng, 200, feats) if kind == "categorical"
         else synth.random_rows(rng, 200, feats)).astype(np.float64)
    want = np.zeros((200, feats + 1))
    for t in ref:
        tree_shap_accumulate(t, X, want)
    port = lgt.Booster(model_str=text, params=CPU)._booster.models
    paths = shap.to_device(shap.build_paths(port, [0] * len(port), 1),
                           torch.device("cpu"))
    got = shap.tree_shap(torch.from_numpy(X), paths)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_paths_merge_repeated_features_and_chunking_is_invisible():
    trees = synth.random_trees(8, 4, 63, 3, grid_size=20)
    paths = shap.build_paths(trees, [0, 1, 0, 1], 2)
    n_elem = np.diff(paths.path_elem_lo)
    n_edge = np.diff(paths.path_edge_lo)
    assert len(n_elem) == sum(t.num_leaves for t in trees)
    # three features: at most three merged elements whatever the depth
    assert n_elem.max() <= 3 and n_edge.max() > 3
    assert paths.max_elems == n_elem.max() + 1
    assert np.array_equal(paths.class_path_lo, [0, 126, 252])
    lo = paths.path_elem_lo
    for p in range(len(n_elem)):
        feats = paths.elem_feat[lo[p]:lo[p + 1]].tolist()
        assert len(set(feats)) == len(feats)
    X = torch.from_numpy(synth.random_rows(np.random.RandomState(1), 90, 3)
                         .astype(np.float64))
    dev = shap.to_device(paths, torch.device("cpu"))
    full = shap._tree_shap_reference(X, dev)
    small = shap._tree_shap_reference(X, dev, max_lattice=4096)
    np.testing.assert_allclose(small.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-15)


def test_stump_and_zero_count_trees_give_expected_value_only():
    stump = Tree(max_leaves=1)
    stump.leaf_value[0] = 0.25
    zero = synth.random_trees(9, 1, 4, 2, grid_size=5)[0]
    zero.leaf_count[:] = 0
    zero.internal_count = [0] * zero.num_internal
    paths = shap.build_paths([stump], [0], 1)
    assert len(paths.path_value) == 0 and paths.bias[0] == 0.25
    assert shap._expected_value(zero) == 0.0


def test_path_cap_names_the_cap():
    # the long-path kernel's caps: only paths of more than 32 elements
    # reach it
    assert shap.path_cap(33) == 64 and shap.path_cap(65) == 128
    assert shap.path_cap(256) == 256
    with pytest.raises(ValueError, match="at most 256"):
        shap.path_cap(257)


def test_tree_shap_refuses_other_devices():
    paths = shap.to_device(shap.build_paths(
        synth.random_trees(1, 1, 4, 2, grid_size=5), [0], 1),
        torch.device("cpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        shap.tree_shap(torch.zeros((2, 2), dtype=torch.float64,
                                   device="meta"), paths)
