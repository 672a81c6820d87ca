"""Three pieces of the data slice held to the JAX package:

* ``data/tail.py``: batches landed by ``write_batch`` come back from
  ``SequenceTail.poll`` once each, in filename order, a torn file skipped
  and retried, as the JAX tail returns them; ``ArraySequence`` views bin
  as the JAX package's, later batches on the first one's mappers;
* quantized level sums past int32: with K2's accumulator limit lowered
  in-process, every quantized histogram is K2 windows summed in int64 and
  the model text is byte-equal to the unwindowed run's; the JAX
  package's fallback (per-chunk scaled float32 sums, triggered the same
  way by lowering its limit) trains the same predictions within rtol
  1e-4 / atol 1e-5 (``tests/test_fused.py:54``);
* ``predict_stream(path)`` equals ``predict(path)`` and the JAX
  package's ``predict(path)``.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest

import lambdagap_tpu as lgb
from lambdagap_tpu.data import tail as jtail
from lambdagap_tpu.ops import hist_pallas
import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.data import tail as ptail
from lambdagap_tpu_torch.ops import hist_cuda, histogram

CPU = {"device_type": "cpu"}


def test_sequence_tail_returns_each_batch_once_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i in (2, 0, 1):
        ptail.write_batch(str(tmp_path), f"batch_{i:03d}", rng.randn(50, 4),
                          rng.rand(50))
    with open(tmp_path / "batch_003.npy", "wb") as f:
        f.write(b"\x93NUMPY torn")                 # a half-landed file
    (tmp_path / "batch_004.npy.tmp.1").write_bytes(b"")
    pt, jt = ptail.SequenceTail(str(tmp_path)), jtail.SequenceTail(
        str(tmp_path))
    got, want = pt.poll(), jt.poll()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pt.poll() == [] and jt.poll() == []
    os.remove(tmp_path / "batch_003.npy")
    ptail.write_batch(str(tmp_path), "batch_003", rng.randn(50, 4),
                      rng.rand(50))
    again = pt.poll()
    assert len(again) == 1
    np.testing.assert_array_equal(again[0], jt.poll()[0])
    X, y = ptail.split_batch(got[0])
    jX, jy = jtail.split_batch(got[0])
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError, match="label column"):
        ptail.split_batch(np.zeros((3, 1)))
    with pytest.raises(ValueError, match="rows"):
        ptail.write_batch(str(tmp_path), "bad", np.zeros((3, 2)),
                          np.zeros(2))

    # batches as Sequences: the first bins as the JAX package's, a later
    # one adopts its mappers
    (X0, y0), (X1, y1) = (ptail.split_batch(b) for b in got[:2])
    p0 = lgt.Dataset(ptail.ArraySequence(X0, batch_size=16), label=y0,
                     params=CPU)
    j0 = lgb.Dataset(jtail.ArraySequence(X0, batch_size=16), label=y0)
    np.testing.assert_array_equal(p0.construct().binned,
                                  j0.construct().binned)
    p1 = lgt.Dataset(ptail.ArraySequence(X1), label=y1, reference=p0,
                     params=CPU).construct()
    assert p1.mappers is p0.construct().mappers
    np.testing.assert_array_equal(
        p1.binned, lgb.Dataset(jtail.ArraySequence(X1), label=y1,
                               reference=j0).construct().binned)


def _quant_data(n=4000, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] > 0).astype(float)
    return X, y


QPARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
           "use_quantized_grad": True, "num_grad_quant_bins": 4,
           "min_data_in_leaf": 20}


@pytest.mark.parametrize("layout", ["gather", "sorted"])
def test_windowed_quantized_sums_train_byte_equal(layout, monkeypatch):
    X, y = _quant_data()
    p = {**QPARAMS, **CPU, "tree_layout": layout, "bagging_fraction": 0.8,
         "bagging_freq": 1}
    base = lgt.train(p, lgt.Dataset(X, label=y), 4).model_to_string()
    monkeypatch.setattr(hist_cuda, "K2_ACCUM_LIMIT", 900 * 4)
    histogram.QUANT_WINDOWS.reset()
    bst = lgt.train(p, lgt.Dataset(X, label=y), 4)
    assert bst._booster.learner.q_window == 900
    assert bst.model_to_string() == base
    # each root takes ceil(4000 / 900) = 5 windows, each child one or more
    assert histogram.QUANT_WINDOWS.launches >= 4 * (5 + 13)


def test_windowed_quantized_sums_hold_jax_fallback(monkeypatch):
    """The JAX fused learner's fallback (per-chunk scaled float32 sums)
    and the port's int64 windows train the same predictions, each package
    pushed past its limit by lowering it in-process."""
    X, y = _quant_data(n=6000, seed=4)
    monkeypatch.setattr(hist_pallas, "exact_accum_limit",
                        lambda impl: 1000 * 4)
    monkeypatch.setattr(hist_cuda, "K2_ACCUM_LIMIT", 1000 * 4)
    p = {**QPARAMS, "stochastic_rounding": False}
    jb = lgb.train({**p, "tpu_fused_learner": "1", "tpu_hist_impl": "onehot"},
                   lgb.Dataset(X, label=y), 5)
    assert not jb._booster.learner.quant_exact
    pb = lgt.train({**p, **CPU}, lgt.Dataset(X, label=y), 5)
    assert pb._booster.learner.q_window == 1000
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["csv", "libsvm"])
def test_predict_stream_of_a_path_equals_predict(kind, tmp_path):
    rng = np.random.RandomState(6)
    X = rng.randn(700, 5)
    X[rng.rand(700) < 0.3, 2] = 0.0
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    jb = lgb.train(params, lgb.Dataset(X, label=y), 4)
    pb = lgt.Booster(model_str=jb.model_to_string(), params=CPU)
    path = str(tmp_path / ("d.csv" if kind == "csv" else "d.svm"))
    if kind == "csv":
        np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    else:
        with open(path, "w") as f:
            for i in range(len(y)):
                f.write(" ".join([str(int(y[i]))] + [
                    f"{j}:{float(X[i, j])!r}" for j in range(5)
                    if X[i, j] != 0]) + "\n")
    st = {}
    got = pb.predict_stream(path, window_rows=256, stats_out=st)
    assert st["windows"] == 3 and st["rows"] == 700
    np.testing.assert_array_equal(got, pb.predict(path))
    np.testing.assert_array_equal(got, pb.predict(X))
    np.testing.assert_allclose(got, jb.predict(path), rtol=1e-6, atol=1e-7)
