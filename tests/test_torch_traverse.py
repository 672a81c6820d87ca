"""The port's compiled-forest traversal (kernel K3's plain version and
its wrapper) against the JAX package's ``_traverse_all``.

On the same artifact blocks, the port's plain traversal must give a node
carry ``array_equal`` to the JAX package's Pallas kernel (interpret mode
on the CPU, as tests/test_infer.py runs it), across row blocks of 32, 100
and 256, NaN/default-left and zero-missing routing, multiclass forests and
hostile categorical values. On a CPU tensor the kernel wrapper takes the
plain version and never counts a launch (the kernel itself is held to the
plain version on the card by tests/test_torch_kernels.py).
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.infer import compile_forest as jax_compile
from lambdagap_tpu.infer import engine as jax_engine
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.infer import engine as eng

HOSTILE = np.array([1e10, -1e10, -3.5, 70.9, np.nan, 69.0, 69.5, -0.5,
                    3e9, 0.0], np.float32)


def _data(rows=601, feats=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    X[::11] = np.nan
    return X, (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0
               ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model(case):
    """(JAX booster, rows) for one case; cached across row blocks (the
    tests only read both)."""
    X, y = _data()
    p = {"verbose": -1, "objective": "binary", "num_leaves": 15}
    cats = "auto"
    if case == "zero_as_missing":
        X[::5, 1] = 0.0
        X[::3, 0] = 0.0
        p["zero_as_missing"] = True
    elif case == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclass", num_class=3)
    elif case == "categorical_hostile":
        rng = np.random.RandomState(3)
        X[:, 0] = rng.randint(0, 70, size=X.shape[0]).astype(np.float32)
        y = ((X[:, 0].astype(int) % 5 < 2) ^ (X[:, 1] > 0)
             ).astype(np.float32)
        p.update(num_leaves=31, min_data_per_group=5)
        cats = [0]
    b = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=cats),
                  num_boost_round=8)
    if case == "categorical_hostile":
        X = X.copy()
        X[::2, 0] = HOSTILE[np.arange(0, len(X), 2) % len(HOSTILE)]
    return b, X


def _jax_carry(b, X, row_block):
    art = jax_compile(b._booster)
    blocks, depths = jax_engine._device_blocks(art.buffers)
    return np.asarray(jax_engine._traverse_all(jnp.asarray(X), blocks,
                                               depths, row_block))


def _port_tables(b):
    port = lgt.Booster(model_str=b.model_to_string(),
                       params={"device_type": "cpu"})
    return eng.device_tables(compile_forest(port._booster),
                             torch.device("cpu"))


@pytest.mark.parametrize("row_block", [32, 100, 256])
@pytest.mark.parametrize("case", ["binary_nan", "zero_as_missing",
                                  "multiclass", "categorical_hostile"])
def test_plain_traversal_equals_jax_traverse_all(case, row_block):
    b, X = _model(case)
    ref = _jax_carry(b, X, row_block)
    tables = _port_tables(b)
    got = eng._traverse_all_reference(torch.from_numpy(X), tables).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert (got < 0).all()                        # every entry is ~leaf
    # ragged tails slice exactly: a prefix of rows is the prefix carry
    head = eng._traverse_all_reference(torch.from_numpy(X[:599]), tables)
    assert np.array_equal(head.numpy(), ref[:599])


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    b, X = _model("categorical_hostile")
    tables = _port_tables(b)
    eng.TRAVERSE_LAUNCHES.reset()
    x = torch.from_numpy(X)
    got = eng.traverse_forest(x, tables)
    assert eng.TRAVERSE_LAUNCHES.launches == 0
    assert torch.equal(got, eng._traverse_all_reference(x, tables))


def test_category_cast_saturates_like_xla():
    """jnp f32 -> int32 saturates (1e10 -> INT_MAX); the port's plain
    version reproduces it instead of torch's wrapping CPU cast."""
    v = torch.tensor([1e10, -1e10, -3.5, 70.9, float("nan"), 3e9, -0.5])
    from lambdagap_tpu_torch.ops.predict import category_of
    want = np.asarray(jnp.where(jnp.isnan(jnp.asarray(v.numpy())), -1,
                                jnp.asarray(v.numpy())).astype(jnp.int32))
    assert np.array_equal(category_of(v).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("es", [(0, 0.0), (3, 0.5)])
@pytest.mark.parametrize("num_class", [1, 3])
def test_accumulate_equals_jax_scan(num_class, es):
    """The forest-order accumulation (one f32 add per tree, early-stop
    replay included) equals the JAX package's lax.scan bit for bit."""
    rng = np.random.RandomState(num_class)
    T, R = 12 * num_class, 97
    vals = (rng.randn(R, T) * 0.7).astype(np.float32)
    tc = np.asarray([i % num_class for i in range(T)], np.int32)
    freq, margin = es[0] * num_class, es[1]
    carry = (jnp.zeros((num_class, R), jnp.float32),
             jnp.zeros(R, dtype=bool), jnp.int32(0))
    ref = np.asarray(jax_engine._accumulate(
        jnp.asarray(vals), jnp.asarray(tc), carry, num_class, freq,
        jnp.float32(margin))[0])
    got = eng._accumulate(torch.from_numpy(vals), tc.tolist(), num_class,
                          freq, margin).numpy()
    assert np.array_equal(got, ref)
