"""``predict_stream`` in the port, on the CPU.

* Raw scores of a JAX-trained model (NaN and a categorical column) loaded
  into the port are ``array_equal`` to the JAX package's
  ``predict_stream`` and to the port's own ``predict``, on every engine,
  at several ``window_rows`` with a ragged tail, at ring depths 1 and 4.
* Converted output and a 3-class model equal the port's ``predict``; an
  ``np.memmap`` source writes an ``np.memmap`` ``out`` in place; a binned
  ``ShardedBinnedDataset`` source (``reference=`` the training set) equals
  ``predict`` on the raw rows, ``compiled`` demoting with the JAX warning.
* ``pred_contrib`` a window at a time equals the JAX package's streamed
  contributions at TreeSHAP's bar (rtol 1e-9 / atol 1e-12, the bar of
  ``tests/test_torch_shap.py``) and the port's resident ``pred_contrib`` of
  the same f32 rows exactly.
* ``Backoff``'s delay sequence and schedule, and ``CoTenantThrottle``'s
  snapshots under a scripted signal, equal the JAX package's.
* ``stats_out`` carries the JAX package's keys; the file source,
  ``mesh_shape`` and ``profile_stream_start_window`` refuse by name.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import logging

import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.guard.backoff import Backoff as JaxBackoff
from lambdagap_tpu.infer.stream import CoTenantThrottle as JaxThrottle
from lambdagap_tpu_torch.guard.backoff import Backoff
from lambdagap_tpu_torch.infer.stream import CoTenantThrottle, _pow2_bucket

CPU = {"device_type": "cpu"}
ROWS = 1603          # ragged against every window size used below


def _data(n=ROWS, d=10, seed=7):
    """tests/test_predict_stream.py's data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[rng.rand(n, d) < 0.05] = np.nan
    X[:, 3] = rng.randint(0, 7, n)
    y = (np.nan_to_num(X[:, 0]) + 0.5 * (X[:, 3] % 3)
         + 0.1 * rng.randn(n))
    return X, y


def _jax_model(objective="regression", num_class=1, seed=7):
    X, y = _data(seed=seed)
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 10, "learning_rate": 0.2, "verbose": -1,
              "tpu_fast_predict_rows": 0, "predict_engine": "compiled"}
    if num_class > 1:
        params["num_class"] = num_class
        y = np.random.RandomState(seed).randint(0, num_class, len(y))
    b = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[3],
                                      params=params), 6)
    return b, X


@pytest.fixture(scope="module")
def reg():
    return _jax_model()


@pytest.fixture(scope="module")
def multi():
    return _jax_model("multiclass", 3, seed=13)


def _port(jb, engine="compiled", **extra):
    return lgt.Booster(model_str=jb.model_to_string(),
                       params={**CPU, "predict_engine": engine, **extra})


@pytest.mark.parametrize("engine", ["compiled", "tensor", "scan"])
@pytest.mark.parametrize("window_rows,depth", [(256, 2), (512, 1),
                                               (1 << 16, 4)])
def test_raw_scores_equal_jax_and_predict(reg, engine, window_rows, depth):
    jb, X = reg
    bst = _port(jb, engine, predict_stream_depth=depth)
    stats = {}
    got = bst.predict_stream(X, raw_score=True, window_rows=window_rows,
                             stats_out=stats)
    want = jb._booster.predict_stream(X, raw_score=True,
                                      window_rows=window_rows)
    assert np.array_equal(got, want)
    assert np.array_equal(got, bst.predict(X, raw_score=True))
    W = min(window_rows, _pow2_bucket(ROWS, window_rows, 1))
    assert stats["windows"] == -(-ROWS // W) and stats["rows"] == ROWS
    assert stats["depth"] == depth and stats["mesh"] is None
    assert len(stats["records"]) == stats["windows"]
    assert set(stats["phases"]) == {"h2d_prefetch", "chunk_wait",
                                    "d2h_scores"}


def test_stats_keys_equal_jax(reg):
    jb, X = reg
    got, want = {}, {}
    _port(jb).predict_stream(X, window_rows=512, stats_out=got)
    jb._booster.predict_stream(X, window_rows=512, stats_out=want)
    assert set(got) == set(want)
    for k in ("rows", "windows", "window_rows", "buckets", "depth",
              "engine", "throttle"):
        assert got[k] == want[k], k
    got, want = {}, {}
    _port(jb).predict_stream(X[:300], pred_contrib=True, window_rows=128,
                             stats_out=got)
    jb._booster.predict_stream(X[:300], pred_contrib=True, window_rows=128,
                               stats_out=want)
    assert set(got) == set(want)
    assert (got["rows"], got["windows"]) == (want["rows"], want["windows"])


def test_multiclass_and_converted_output(multi):
    """3-class raw scores equal the JAX package's; converted (softmax)
    scores equal the port's ``predict`` (the libraries' ``exp`` may part by
    an ulp, so converted outputs are held to the port's own)."""
    jb, X = multi
    bst = _port(jb, "tensor")
    raw = bst.predict_stream(X, raw_score=True, window_rows=300)
    assert raw.shape == (ROWS, 3)
    assert np.array_equal(raw, jb._booster.predict_stream(
        X, raw_score=True, window_rows=300))
    assert np.array_equal(bst.predict_stream(X, window_rows=300),
                          bst.predict(X))
    assert bst.predict_stream(X, num_iteration=0).shape == (ROWS, 3)
    assert not bst.predict_stream(X, raw_score=True, num_iteration=0).any()


def test_memmap_source_and_memmap_out(reg, tmp_path):
    jb, X = reg
    bst = _port(jb)
    src = np.memmap(tmp_path / "x.bin", dtype=np.float64, mode="w+",
                    shape=X.shape)
    src[:] = X
    src.flush()
    src = np.memmap(tmp_path / "x.bin", dtype=np.float64, mode="r",
                    shape=X.shape)
    out = np.memmap(tmp_path / "y.bin", dtype=np.float32, mode="w+",
                    shape=(ROWS,))
    ret = bst.predict_stream(src, window_rows=256, out=out)
    assert ret is out
    assert np.array_equal(np.asarray(out), bst.predict(X))
    contrib = np.memmap(tmp_path / "c.bin", dtype=np.float64, mode="w+",
                        shape=(300, X.shape[1] + 1))
    bst.predict_stream(src[:300], pred_contrib=True, window_rows=128,
                       out=contrib)
    assert np.array_equal(np.asarray(contrib),
                          bst.predict(X[:300], pred_contrib=True))


@pytest.mark.parametrize("engine", ["compiled", "tensor", "scan"])
def test_binned_source_equals_predict(engine, caplog):
    """A ShardedBinnedDataset built with ``reference=`` the training set
    scores through the inner-feature bin tables to the raw rows' scores;
    ``compiled`` demotes to the tensor engine with the JAX warning."""
    X, y = _data()
    params = {**CPU, "objective": "regression", "num_leaves": 15,
              "verbose": 0, "predict_engine": engine}
    tr = lgt.Dataset(X, label=y, categorical_feature=[3])
    bst = lgt.train(params, tr, 5)
    Xv, _ = _data(n=900, seed=8)
    sv = lgt.ShardedBinnedDataset.from_matrix(
        Xv, bst._booster.config, shard_rows=1024, reference=tr.construct())
    with caplog.at_level(logging.WARNING, logger="lambdagap_tpu_torch"):
        got = bst.predict_stream(sv, raw_score=True, window_rows=256)
    assert np.array_equal(got, bst.predict(Xv, raw_score=True))
    demoted = any("scores binned windows through the tensor engine"
                  in r.getMessage() for r in caplog.records)
    assert demoted == (engine == "compiled")
    loaded = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    with pytest.raises(RuntimeError, match="training feature metadata"):
        loaded.predict_stream(sv)


@pytest.mark.parametrize("which", ["reg", "multi"])
def test_pred_contrib_equals_jax(which, request):
    jb, X = request.getfixturevalue(which)
    bst = _port(jb)
    sub = X[:700].astype(np.float64) * 1.0000001   # not f32-representable
    got = bst.predict_stream(sub, pred_contrib=True, window_rows=256)
    want = jb._booster.predict_stream(sub, pred_contrib=True,
                                      window_rows=256)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    # the windows are the f32-rounded rows, as the JAX package's are
    assert np.array_equal(got, bst.predict(sub.astype(np.float32),
                                           pred_contrib=True))


@pytest.mark.parametrize("kw", [
    {"base_s": 0.05, "factor": 2.0, "max_s": 2.0, "jitter": 0.1, "seed": 18},
    {"base_s": 0.5, "factor": 3.0, "max_s": 30.0, "jitter": 0.25, "seed": 3},
    {"base_s": 0.01, "factor": 2.0, "max_s": 10.0, "jitter": 0.0}])
def test_backoff_sequence_equals_jax(kw):
    clock = iter(range(1000))
    t = Backoff(**kw, clock=lambda: next(clock))
    clock_j = iter(range(1000))
    j = JaxBackoff(**kw, clock=lambda: next(clock_j))
    assert [t.delay_for(k) for k in range(12)] == \
        [j.delay_for(k) for k in range(12)]
    steps = ["f", "f", "r", "f", "ready", "s", "f", "snap"]
    for step in steps:
        for b in (t, j):
            out = {"f": b.note_failure, "r": b.rearm, "s": b.note_success,
                   "ready": b.ready, "snap": b.snapshot}[step]()
            if b is t:
                mine = out
        assert mine == out, step
    assert t.snapshot() == j.snapshot()


def _sig(margin, frac=0.99):
    return {"goodput": {"knee_rps": 100.0, "knee_margin": margin,
                        "good_fraction": frac, "good_ratio": 0.9}}


def test_throttle_snapshots_equal_jax(reg):
    """The same scripted signals (pressure, recovery, low goodput, a dead
    source) give the JAX throttle's delays and snapshots check by check;
    inside predict_stream the gate runs before each window and the scores
    stay exact."""
    script = [_sig(0.02)] * 3 + [_sig(0.5)] * 2 + [_sig(0.5, 0.5)] + \
        [RuntimeError("gone")] + [_sig(0.02)] * 2

    def source(seq):
        it = iter(seq)

        def nxt():
            v = next(it)
            if isinstance(v, Exception):
                raise v
            return v
        return nxt

    slept_t, slept_j = [], []
    t = CoTenantThrottle(source(script), sleep=slept_t.append)
    j = JaxThrottle(source(script), sleep=slept_j.append)
    for _ in script:
        t()
        j()
        assert t.snapshot() == j.snapshot()
    assert slept_t == slept_j and len(slept_t) == 6
    jb, X = reg
    bst = _port(jb)
    slept = []
    th = CoTenantThrottle(source([_sig(0.02)] * 3 + [_sig(0.5)] * 100),
                          backoff=Backoff(base_s=0.01, max_s=0.1,
                                          jitter=0.0, seed=1),
                          sleep=slept.append)
    got = bst._booster.predict_stream(X, raw_score=True, window_rows=128,
                                      throttle=th)
    assert np.array_equal(got, bst.predict(X, raw_score=True))
    assert slept == [0.01, 0.02, 0.04] and not th.engaged
    bst._booster.config.predict_stream_throttle = "off"
    calls = []
    bst._booster.predict_stream(X, window_rows=512, throttle=CoTenantThrottle(
        lambda: calls.append(1) or _sig(0.02), sleep=lambda s: None))
    assert not calls


def test_unported_sources_and_knobs_refuse_by_name(reg, tmp_path):
    jb, X = reg
    # a data file is a source now (label column 0 stripped), scored a
    # window at a time as predict(path) scores it
    path = tmp_path / "rows.csv"
    np.savetxt(path, np.column_stack([np.zeros(300), X[:300]]),
               delimiter=",")
    port = _port(jb)
    st = {}
    got = port.predict_stream(str(path), window_rows=128, stats_out=st)
    assert np.array_equal(got, port.predict(str(path)))
    assert np.array_equal(got, port.predict(X[:300]))
    assert st["windows"] == 3 and st["rows"] == 300
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        _port(jb, mesh_shape="2x4").predict_stream(X)
    with pytest.raises(NotImplementedError,
                       match="profile_stream_start_window"):
        _port(jb, profile_stream_start_window=0).predict_stream(X)
