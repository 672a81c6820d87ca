"""The PyTorch port's model text and numpy carry-over against the JAX
package.

A model the JAX package trains and saves must load in
``lambdagap_tpu_torch`` with equal tree fields; the port's writer must give
the same tree region byte for byte (the compiled artifact's source key
hashes it); and ``convert.trees_from_numpy`` must build the same trees as
the text route. A model the port trains, with any objective, must carry
the header the JAX package writes for it and round-trip byte for byte.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools

import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.serve.delta import split_model_text as jax_split
from lambdagap_tpu_torch.convert import (booster_from_numpy, tree_fields,
                                         trees_from_numpy)
from lambdagap_tpu_torch.serve.delta import split_model_text

CPU = {"device_type": "cpu"}


def _data(rows=500, feats=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    X[::5, 1] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0)
    return X, y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX booster, rows) for one model shape."""
    X, y = _data()
    base = {"verbose": -1, "num_leaves": 15}
    if name == "binary":
        p = {**base, "objective": "binary"}
    elif name == "zero_as_missing":
        p = {**base, "objective": "binary", "zero_as_missing": True}
    elif name == "categorical":
        rng = np.random.RandomState(3)
        X[:, 0] = rng.randint(0, 70, size=X.shape[0]).astype(np.float32)
        y = ((X[:, 0].astype(int) % 5 < 2) ^ (X[:, 1] > 0)).astype(np.float32)
        p = {**base, "objective": "binary", "min_data_per_group": 5}
        return lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[0]),
                         num_boost_round=6), X
    elif name == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p = {**base, "objective": "multiclass", "num_class": 3}
    elif name == "regression_sqrt":
        y = X[:, 0] * 3.0 + np.nan_to_num(X[:, 3])
        p = {**base, "objective": "regression", "reg_sqrt": True}
    elif name == "multiclass7":
        y = np.digitize(X[:, 0] + X[:, 2], [-2, -1, -.4, .4, 1, 2])
        p = {**base, "objective": "multiclass", "num_class": 7}
    elif name == "multiclassova":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p = {**base, "objective": "multiclassova", "num_class": 3}
    elif name == "quantile":
        y = X[:, 0] * 3.0 + np.nan_to_num(X[:, 3])
        p = {**base, "objective": "quantile", "alpha": 0.9}
    elif name == "xentropy":
        y = 1.0 / (1.0 + np.exp(-2.0 * X[:, 0]))
        p = {**base, "objective": "cross_entropy"}
    else:
        raise ValueError(name)
    return lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=6), X


CASES = ["binary", "zero_as_missing", "categorical", "multiclass",
         "regression_sqrt", "multiclass7", "multiclassova", "quantile",
         "xentropy"]

_TREE_FIELDS = ("split_feature", "threshold_real", "default_left",
                "missing_type", "left_child", "right_child",
                "is_categorical", "split_gain", "internal_value",
                "internal_weight", "internal_count")


def _assert_same_tree(port, ref):
    n = ref.num_internal
    assert port.num_leaves == ref.num_leaves
    assert port.shrinkage == ref.shrinkage
    for k in _TREE_FIELDS:
        assert list(getattr(port, k)[:n]) == list(getattr(ref, k)[:n]), k
    for k in ("leaf_value", "leaf_weight", "leaf_count"):
        assert np.array_equal(getattr(port, k)[:ref.num_leaves],
                              getattr(ref, k)[:ref.num_leaves]), k
    for i in range(n):
        a = np.trim_zeros(np.asarray(port.cat_bitset_real[i]), "b")
        b = np.trim_zeros(np.asarray(ref.cat_bitset_real[i]), "b")
        assert np.array_equal(a, b)
    assert port.max_depth == ref.max_depth
    assert np.array_equal(port.leaf_depth[:n + 1], ref.leaf_depth[:n + 1])


@pytest.mark.parametrize("name", CASES)
def test_jax_text_loads_with_equal_tree_fields(name):
    b, _X = _case(name)
    text = b.model_to_string()
    port = lgt.Booster(model_str=text, params=CPU)
    ref = lgb.Booster(model_str=text)
    assert port.num_trees() == ref.num_trees()
    assert port.num_model_per_iteration() == ref.num_model_per_iteration()
    assert port.num_feature() == ref.num_feature()
    assert port._booster.objective_string() == \
        ref._booster.objective_string()
    for pt, rt in zip(port._booster.models, ref._booster.host_models):
        _assert_same_tree(pt, rt)


@pytest.mark.parametrize("name", CASES)
def test_port_save_gives_byte_identical_tree_region(name, tmp_path):
    b, _X = _case(name)
    text = b.model_to_string()
    port = lgt.Booster(model_str=text, params=CPU)
    _h, jax_blocks, _t = jax_split(text)
    _h2, port_blocks, _t2 = split_model_text(port.model_to_string())
    assert "".join(port_blocks) == "".join(jax_blocks)
    # a second round trip through the port is byte-stable end to end
    again = lgt.Booster(model_str=port.model_to_string(), params=CPU)
    assert again.model_to_string() == port.model_to_string()
    path = tmp_path / "m.txt"
    port.save_model(str(path))
    from_file = lgt.Booster(model_file=str(path), params=CPU)
    assert from_file.model_to_string() == port.model_to_string()


@pytest.mark.parametrize("name", CASES)
def test_trees_from_numpy_matches_text_route(name):
    b, X = _case(name)
    text = b.model_to_string()
    by_text = lgt.Booster(model_str=text, params=CPU)
    fields = [tree_fields(t) for t in b._booster.host_models]
    trees = trees_from_numpy(fields)
    for pt, rt in zip(trees, by_text._booster.models):
        _assert_same_tree(pt, rt)
    from lambdagap_tpu_torch.models.model_text import load_model_from_string
    header, _ = load_model_from_string(text)
    by_numpy = booster_from_numpy(header, trees, params=CPU)
    _h, a, _t = split_model_text(by_numpy.model_to_string())
    _h, c, _t = split_model_text(by_text.model_to_string())
    assert a == c
    assert np.array_equal(by_numpy.predict(X, raw_score=True),
                          by_text.predict(X, raw_score=True))


HEADER_KEYS = ("objective", "num_class", "num_tree_per_iteration")


def _header(text):
    lines = text.split("\n\n", 1)[0].splitlines()
    return {k: v for k, v in (ln.split("=", 1) for ln in lines if "=" in ln)
            if k in HEADER_KEYS}


@pytest.mark.parametrize("objective, extra, want", [
    ("multiclass", {"num_class": 7}, "multiclass num_class:7"),
    ("multiclassova", {"num_class": 7},
     "multiclassova num_class:7 sigmoid:1"),
    ("multiclassova", {"num_class": 3, "sigmoid": 1.5},
     "multiclassova num_class:3 sigmoid:1.5"),
    ("regression_l1", {}, "regression_l1"), ("huber", {}, "huber"),
    ("fair", {}, "fair"), ("poisson", {}, "poisson"),
    ("quantile", {"alpha": 0.9}, "quantile"), ("mape", {}, "mape"),
    ("gamma", {}, "gamma"), ("tweedie", {}, "tweedie"),
    ("cross_entropy", {}, "cross_entropy"),
    ("cross_entropy_lambda", {}, "cross_entropy_lambda"),
])
def test_trained_model_header_reads_as_jax_writes_it(objective, extra, want):
    """The port trains two rounds; its text's objective line is the JAX
    package's, the JAX package reloads it and writes the same header, and
    the port reloads it to the same header and tree region byte for byte
    (the parameters section keeps the loading run's own), and from then on
    round-trips it byte for byte."""
    X, _y = _data(rows=300)
    K = extra.get("num_class", 1)
    y = (np.arange(300) % K if K > 1
         else 1.0 / (1.0 + np.exp(-np.nan_to_num(X[:, 0])))
         if objective.startswith("cross") else np.abs(X[:, 0]) + 0.5)
    bst = lgt.train({"objective": objective, "num_leaves": 7,
                     "verbose": -1, **extra, **CPU},
                    lgt.Dataset(X, label=y), 2)
    text = bst.model_to_string()
    head = _header(text)
    assert head == {"objective": want, "num_class": str(K),
                    "num_tree_per_iteration": str(K)}
    assert _header(lgb.Booster(model_str=text).model_to_string()) == head
    again = lgt.Booster(model_str=text, params=CPU)
    h1, blocks, _t = split_model_text(text)
    h2, blocks2, _t = split_model_text(again.model_to_string())
    assert h2 == h1 and blocks2 == blocks
    third = lgt.Booster(model_str=again.model_to_string(), params=CPU)
    assert third.model_to_string() == again.model_to_string()
    assert bst.num_trees() == 2 * K
