"""The PyTorch port's forest compiler against the JAX package's.

``infer/compile.py`` is host numpy in both packages, so for the same model
text and the same ``infer_*`` knobs the port must emit the same artifact:
``array_equal`` buffers of equal dtypes, equal ``meta``, an equal
``source_key`` and sha256 ``hash``, and identical ``to_bytes()``.
"""
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.infer import compile_forest as jax_compile
from lambdagap_tpu_torch.infer import (ArtifactMismatch, ArtifactStore,
                                       ForestArtifact, compile_forest)


def _data(rows=600, feats=8, seed=0, nan_col=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    if nan_col is not None:
        X[::7, nan_col] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0)
    return X, y.astype(np.float32)


def _model(case):
    """(JAX booster trained for one case, infer knobs) — the knobs go to
    both packages' configs."""
    base = {"verbose": -1, "objective": "binary", "num_leaves": 15}
    knobs = {}
    cats = "auto"
    X, y = _data()
    if case == "binary_nan_default_left":
        p = base
    elif case == "zero_as_missing":
        X, y = _data(nan_col=None)
        X[::5, 1] = 0.0
        X[::3, 0] = 0.0
        p = {**base, "zero_as_missing": True}
    elif case == "categorical_70":
        rng = np.random.RandomState(3)
        X[:, 0] = rng.randint(0, 70, size=X.shape[0]).astype(np.float32)
        y = ((X[:, 0].astype(int) % 5 < 2) ^ (X[:, 1] > 0)).astype(np.float32)
        p = {**base, "num_leaves": 31, "min_data_per_group": 5}
        cats = [0]
    elif case == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p = {**base, "objective": "multiclass", "num_class": 3}
    elif case == "quant_u16":
        p = base
        knobs = {"infer_quant": "u16"}
    elif case == "widened_past_256":
        X, _ = _data(rows=1200)
        y = np.sin(np.nan_to_num(X).sum(axis=1))
        p = {**base, "objective": "regression", "num_leaves": 31}
    elif case.startswith("merge") or case.startswith("prune"):
        # iteration-tiled structure: many trees share a pruned structure
        p = {**base, "num_leaves": 8}
        flag = case.endswith("_on")
        knobs = ({"infer_merge_trees": flag} if case.startswith("merge")
                 else {"infer_prune": flag})
    else:
        raise ValueError(case)
    rounds = 30 if case == "widened_past_256" else 8
    b = lgb.train({**p, **knobs},
                  lgb.Dataset(X, label=y, categorical_feature=cats),
                  num_boost_round=rounds)
    return b, knobs


CASES = ["binary_nan_default_left", "zero_as_missing", "categorical_70",
         "multiclass", "quant_u16", "widened_past_256", "merge_on",
         "merge_off", "prune_on", "prune_off"]


def _assert_same_artifact(port, ref):
    assert port.meta == ref.meta
    assert sorted(port.buffers) == sorted(ref.buffers)
    for k in ref.buffers:
        assert port.buffers[k].dtype == ref.buffers[k].dtype, k
        assert port.buffers[k].shape == ref.buffers[k].shape, k
        assert np.array_equal(port.buffers[k], ref.buffers[k]), k
    assert port.source_key == ref.source_key
    assert port.hash == ref.hash
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("case", CASES)
def test_port_artifact_equals_jax_artifact(case):
    b, knobs = _model(case)
    ref = jax_compile(b._booster)
    port_b = lgt.Booster(model_str=b.model_to_string(),
                         params={"device_type": "cpu", **knobs})
    port = compile_forest(port_b._booster)
    _assert_same_artifact(port, ref)
    if case == "categorical_70":
        assert ref.meta["cat_words"] >= 3
    if case in ("quant_u16", "widened_past_256"):
        assert ref.meta["thr_bits"] == 16
    if case == "widened_past_256":
        assert len(ref.buffers["thr_table"]) > 256


@pytest.mark.parametrize("case", ["binary_nan_default_left", "multiclass"])
def test_slice_artifacts_equal(case):
    """A forest slice (start/num iteration) compiles to the same artifact
    and source key in both packages."""
    b, knobs = _model(case)
    port_b = lgt.Booster(model_str=b.model_to_string(),
                         params={"device_type": "cpu", **knobs})
    _assert_same_artifact(compile_forest(port_b._booster, 2, 3),
                          jax_compile(b._booster, 2, 3))


def test_jax_artifact_admitted_by_port_store_and_mismatch_is_loud():
    """Bytes compiled by the JAX package admit into the port's store by
    hash; a corrupted payload raises and leaves the store empty."""
    b, _ = _model("binary_nan_default_left")
    payload = jax_compile(b._booster).to_bytes()
    store = ArtifactStore()
    bad = bytearray(payload)
    bad[-1] ^= 0xFF
    with pytest.raises(ArtifactMismatch):
        store.admit_bytes(bytes(bad))
    assert len(store) == 0
    art = ForestArtifact.from_bytes(payload)
    got = store.admit_bytes(payload, expect_hash=art.hash)
    assert got.to_bytes() == payload
    with pytest.raises(ArtifactMismatch):
        ForestArtifact.from_bytes(payload, expect_hash="0" * 64)
