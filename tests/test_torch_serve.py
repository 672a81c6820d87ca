"""The whole serving slice of the PyTorch port against the JAX package.

``lambdagap_tpu_torch.Booster(model_str=<JAX text>)`` on the CPU must give
raw scores ``array_equal`` to the JAX package's compiled engine (native
small-batch shortcut off, >512 rows), converted outputs within the
``exp`` difference of the two libraries, its compiled engine
``array_equal`` to its own scan oracle, and its server must answer
concurrent mixed-size requests exactly as its compiled cache does.
"""
import functools
import threading

import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

JAX_PARAMS = {"verbose": -1, "tpu_fast_predict_rows": 0,
              "predict_engine": "compiled"}
ES_BINARY = {"pred_early_stop": True, "pred_early_stop_freq": 3,
             "pred_early_stop_margin": 0.5}
ES_MULTI = {"pred_early_stop": True, "pred_early_stop_freq": 2,
            "pred_early_stop_margin": 1.5}


def _data(rows=700, feats=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    X[::5, 1] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0)
    return X, y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX booster, rows, predict params shared by both packages)."""
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 15}
    shared = {}
    cats = "auto"
    rounds = 10
    if name == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclass", num_class=3)
    elif name == "binary_early_stop":
        shared = ES_BINARY
        rounds = 12
    elif name == "multiclass_early_stop":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclass", num_class=3)
        shared = ES_MULTI
        rounds = 9
    elif name == "zero_as_missing":
        p["zero_as_missing"] = True
    elif name == "categorical":
        rng = np.random.RandomState(3)
        X[:, 0] = rng.randint(0, 70, size=X.shape[0]).astype(np.float32)
        y = ((X[:, 0].astype(int) % 5 < 2) ^ (X[:, 1] > 0)
             ).astype(np.float32)
        p.update(num_leaves=31, min_data_per_group=5)
        cats = [0]
    elif name == "multiclassova":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclassova", num_class=3)
    elif name == "poisson":
        y = np.exp(0.3 * np.nan_to_num(X[:, 0])).astype(np.float32)
        p.update(objective="poisson")
    b = lgb.train({**JAX_PARAMS, **p, **shared},
                  lgb.Dataset(X, label=y, categorical_feature=cats),
                  num_boost_round=rounds)
    return b, X, shared


def _port(b, engine="compiled", **extra):
    return lgt.Booster(model_str=b.model_to_string(),
                       params={"device_type": "cpu",
                               "predict_engine": engine, **extra})


CASES = ["binary", "multiclass", "binary_early_stop",
         "multiclass_early_stop", "zero_as_missing", "categorical",
         "multiclassova", "poisson"]


@pytest.mark.parametrize("name", CASES)
def test_raw_scores_equal_jax_compiled(name):
    b, X, shared = _case(name)
    ref = b.predict(X, raw_score=True)
    got = _port(b, **shared).predict(X, raw_score=True)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), np.nanmax(np.abs(got - ref))


@pytest.mark.parametrize("name", CASES)
def test_converted_scores_close_to_jax(name):
    """exp differs between the libraries; everything else is the same f32
    arithmetic, so converted outputs agree to a few f32 ulps."""
    b, X, shared = _case(name)
    ref = b.predict(X)
    got = _port(b, **shared).predict(X)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", CASES)
def test_port_compiled_equals_port_scan(name):
    b, X, shared = _case(name)
    got = _port(b, "compiled", **shared).predict(X, raw_score=True)
    ref = _port(b, "scan", **shared).predict(X, raw_score=True)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name, engine", [("binary", "compiled"),
                                          ("multiclass", "compiled"),
                                          ("binary", "scan")])
def test_server_answers_concurrent_mixed_sizes_exactly(name, engine):
    b, X, _ = _case(name)
    bst = _port(b, engine)
    direct = _port(b).predict(X, raw_score=True)       # compiled engine
    server = bst.as_server(raw_score=True, max_delay_ms=1.0)
    cache = server.cache
    sizes = (1, 7, 64, 601)
    jobs = [(t, i, sizes[(t + i) % len(sizes)]) for t in range(3)
            for i in range(8)]
    results = {}

    def client(tid):
        futs = []
        for t, i, n in jobs:
            if t == tid:
                lo = (i * 37) % (len(X) - n)
                futs.append(((t, i), lo, n, server.submit(X[lo:lo + n])))
        for key, lo, n, f in futs:
            results[key] = (lo, n, f.result(timeout=120))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads)
    snap = server.stats_snapshot()
    server.close()
    assert len(results) == len(jobs)
    for (lo, n, res) in results.values():
        want = cache.predict(X[lo:lo + n], raw_score=True, record=False)
        assert res.generation == 0
        assert res.values.shape == want.shape
        assert np.array_equal(res.values, want)
        assert np.array_equal(res.values, direct[lo:lo + n])
    assert snap["requests"] == len(jobs)
    assert snap["rows"] == sum(n for _t, _i, n in jobs)
    assert snap["engine"] == engine
    assert snap["health"]["state"] == "ok"


def test_server_output_equals_booster_predict_and_rejects_narrow_rows():
    b, X, _ = _case("binary")
    bst = _port(b)
    with bst.as_server() as server:
        got = server.predict(X[:601])
        assert np.array_equal(got, bst.predict(X[:601]))
        fut = server.submit(X[:3, :2])
        with pytest.raises(ValueError):
            fut.result(timeout=60)
