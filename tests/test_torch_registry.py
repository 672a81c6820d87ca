"""The port's serve registry, hot swap, delta swap and swap breaker against
the JAX package's.

On the CPU: ``make_delta`` / ``apply_delta`` / ``delta_bytes`` give the
JAX functions' dict, text and int on appended, shrunk and changed pairs of
JAX-trained and port-trained texts, and a frame made by either package
applies to the other's resident text; a stale base, a wrong hash, a
missing key and a wrong format raise ``DeltaMismatch`` in both. One
scripted breaker sequence under an injected clock gives the JAX
``CircuitBreaker``'s states. One scripted ``install`` / ``get`` / ``swap``
/ ``remove`` sequence over three models gives the JAX registry's snapshot
(byte fields aside) and eviction / readmission counts, each package's
budget set from its own entry bytes. Then the port alone: re-admission
keeps the generation, concurrent gets of an evicted model build once,
unknown models raise, a non-default model swaps, malformed text fails the
swap with the old generation serving, the breaker rejects after
``serve_swap_breaker`` failures, a forest on another device fails the
swap, delta swaps serve the full forest, and a hot-swap storm under four
submitting threads never tears a generation. Every comparison of scores
is ``array_equal``.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools
import threading

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.guard.degrade import CircuitBreaker as JaxBreaker
from lambdagap_tpu.serve import delta as jax_delta
from lambdagap_tpu.serve.cache import CompiledForestCache as JaxCache
from lambdagap_tpu.serve.registry import ModelRegistry as JaxRegistry
from lambdagap_tpu.serve.stats import ServeStats as JaxStats
from lambdagap_tpu_torch.guard.degrade import (CircuitBreaker, HealthMonitor,
                                               SwapFailed, SwapRejected)
from lambdagap_tpu_torch.serve import ServeStats, delta
from lambdagap_tpu_torch.serve.cache import CompiledForestCache
from lambdagap_tpu_torch.serve.registry import ModelRegistry
from lambdagap_tpu_torch.serve.swap import SwapController, load_booster

CPU = {"device_type": "cpu", "verbose": -1}
JAX = {"verbose": -1, "tpu_fast_predict_rows": 0,
       "predict_engine": "compiled"}


def _data(seed, rows=700, feats=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    y = (X[:, 0] + 0.5 * X[:, seed % 3 + 1] > 0.2 * seed).astype(np.float32)
    return X, y


@functools.lru_cache(maxsize=None)
def _jax_text(seed, rounds=8):
    X, y = _data(seed)
    return lgb.train({**JAX, "objective": "binary", "num_leaves": 15},
                     lgb.Dataset(X, label=y), rounds).model_to_string()


@functools.lru_cache(maxsize=None)
def _port_text(seed, rounds=8):
    X, y = _data(seed)
    return lgt.train({**CPU, "objective": "binary", "num_leaves": 15},
                     lgt.Dataset(X, label=y), rounds).model_to_string()


def _text(pkg, seed, rounds=8):
    return (_jax_text if pkg == "jax" else _port_text)(seed, rounds)


def _head(text, rounds):
    """The first ``rounds`` trees of a model, through the port's writer."""
    return lgt.Booster(model_str=text, params=CPU).model_to_string(
        num_iteration=rounds)


def _scores(text, X):
    return lgt.Booster(model_str=text, params={
        **CPU, "predict_engine": "scan"}).predict(X, raw_score=True)


# -- delta frames ----------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("pair", ["appended", "shrunk", "changed"])
def test_delta_frames_equal_jax(pkg, pair):
    full = _text(pkg, 0)
    if pair == "appended":
        base, new = _head(full, 5), full
    elif pair == "shrunk":
        base, new = full, _head(full, 5)
    else:
        base, new = full, _text(pkg, 1)
    got, want = delta.make_delta(base, new), jax_delta.make_delta(base, new)
    assert got == want
    if pair != "appended":
        assert got is None
        return
    assert delta.delta_bytes(got) == jax_delta.delta_bytes(want) < len(new)
    assert delta.apply_delta(base, got) == jax_delta.apply_delta(base, want) \
        == new
    # the model text is the interchange: a JAX frame applies to the port's
    # resident text, and a port frame to the JAX package's
    port_base = delta.model_text_of(
        lgt.Booster(model_str=base, params=CPU)._booster)
    jax_base = jax_delta.model_text_of(
        lgb.Booster(model_str=base, params=JAX)._booster)
    assert delta.apply_delta(port_base, want) == new
    assert jax_delta.apply_delta(jax_base, got) == new


def _break(frame, how):
    frame = dict(frame)
    if how == "stale_base":
        frame["base_trees"] += 1
    elif how == "wrong_hash":
        frame["base_hash"] = "0" * 64
    elif how == "missing_key":
        del frame["append"]
    else:
        frame["format"] = 2
    return frame


@pytest.mark.parametrize("how", ["stale_base", "wrong_hash", "missing_key",
                                 "wrong_format"])
def test_delta_mismatch_raises_in_both(how):
    full = _text("jax", 0)
    base = _head(full, 5)
    frame = _break(delta.make_delta(base, full), how)
    with pytest.raises(delta.DeltaMismatch) as ours:
        delta.apply_delta(base, frame)
    with pytest.raises(jax_delta.DeltaMismatch) as theirs:
        jax_delta.apply_delta(base, frame)
    assert str(ours.value) == str(theirs.value)


# -- the breaker -----------------------------------------------------------
@pytest.mark.parametrize("threshold", [2, 0])
def test_breaker_states_equal_jax(threshold):
    script = ["s", "a", "f", "s", "f", "s", "a", "t5", "s", "a", "t11", "s",
              "a", "a", "f", "s", "t22", "s", "a", "ok", "s", "a", "f", "f",
              "f", "s", "t40", "s", "a", "s"]
    runs = []
    for cls in (CircuitBreaker, JaxBreaker):
        t = [0.0]
        br = cls(threshold=threshold, cooldown_s=10.0, clock=lambda: t[0])
        seen = []
        for op in script:
            if op == "s":
                seen.append(br.state())
            elif op == "a":
                seen.append(br.allow())
            elif op == "f":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            else:
                t[0] = float(op[1:])
            seen.append(br.consecutive_failures)
        runs.append(seen)
    assert runs[0] == runs[1]
    states = set(runs[0]) & {"closed", "open", "half_open"}
    assert states == ({"closed", "open", "half_open"} if threshold
                      else {"closed"})


# -- the registry against the JAX registry ---------------------------------
def _port_build(gbdt, gen):
    return CompiledForestCache(gbdt, buckets=(8,), generation=gen)


def _jax_build(gbdt, gen):
    return JaxCache(gbdt, buckets=(8,), generation=gen)


def _strip(snap):
    """A registry snapshot without its byte fields."""
    models = {n: {k: v for k, v in m.items() if k != "hbm_bytes"}
              for n, m in snap["models"].items()}
    return {"models": models, "resident_models": snap["resident_models"],
            "registered_models": snap["registered_models"]}


def _run_script(reg, stats, texts, params):
    """install a, b, c; budget = the two largest entries + 64 bytes (any
    two fit, three do not); then a scripted mix of get / swap / remove.
    Returns the snapshots after each step and the stats' counts."""
    for name in "abc":
        reg.install(name, texts[name], params)
    sizes = sorted(reg.entry(n).bytes for n in "abc")
    assert sizes[0] > 64 and sizes[2] < 1.25 * sizes[0]
    reg.hbm_budget_bytes = sizes[1] + sizes[2] + 64
    snaps = [_strip(reg.snapshot())]
    steps = [("get", "a"), ("remove", "c"), ("install", "c"), ("get", "a"),
             ("get", "b"), ("swap", "c"), ("get", "c"), ("swap", "b"),
             ("get", "a"), ("remove", "b"), ("get", "c"), ("get", "a")]
    for op, name in steps:
        if op == "get":
            reg.get(name)
        elif op == "remove":
            reg.remove(name)
        elif op == "install":
            reg.install(name, texts[name], params)
        else:
            reg.swap(name, texts["d"], params)
        snaps.append(_strip(reg.snapshot()))
    snap = stats.snapshot()
    return snaps, (snap["evictions"], snap["readmissions"], snap["swaps"])


def test_registry_snapshot_and_evictions_equal_jax():
    texts = {k: _jax_text(s) for k, s in zip("abcd", (0, 1, 2, 3))}
    ours_stats, jax_stats = ServeStats(), JaxStats()
    ours = _run_script(ModelRegistry(_port_build, stats=ours_stats,
                                     device=torch.device("cpu")),
                       ours_stats, texts,
                       {**CPU, "predict_engine": "compiled"})
    theirs = _run_script(JaxRegistry(_jax_build, stats=jax_stats),
                         jax_stats, texts, JAX)
    assert ours == theirs
    evictions, readmissions, swaps = ours[1]
    assert evictions > 0 and readmissions > 0 and swaps == 2


# -- the port alone ---------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _booster(seed, rounds=8):
    return lgt.Booster(model_str=_jax_text(seed, rounds),
                       params={**CPU, "predict_engine": "compiled"})


def _server(**kw):
    kw.setdefault("buckets", (8, 64))
    kw.setdefault("warmup", False)
    return lgt.serve.ForestServer(_booster(0), **kw)


def test_readmission_keeps_generation_and_single_flights():
    X, _ = _data(0)
    ref = _scores(_jax_text(0), X[:64])
    s = _server(raw_score=True)
    try:
        s.swap(_jax_text(0))                          # default at gen 1
        s.registry.hbm_budget_bytes = s.registry.entry("default").bytes + 64
        s.add_model("m2", _booster(1)._booster)       # evicts default
        assert not s.registry.entry("default").resident
        outs, errs = [None] * 8, []

        def hit(i):
            try:
                outs[i] = s.submit(X[8 * i:8 * i + 8]).result(30)
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and not errs
        for i, res in enumerate(outs):
            assert res.generation == 1                # generation preserved
            assert np.array_equal(res.values, ref[8 * i:8 * i + 8])
        entry = s.registry.entry("default")
        assert entry.builds == 3                      # install, swap, 1 readmit
        snap = s.stats_snapshot()
        assert snap["readmissions"] == 1 and snap["evictions"] >= 1
        assert s.prefetch("m2")["readmitted"] is True
    finally:
        s.close()


def test_unknown_model_and_non_default_swap():
    X, _ = _data(0)
    s = _server(raw_score=True)
    try:
        with pytest.raises(ValueError, match="unknown serve model"):
            s.submit(X[:4], model="nope")
        with pytest.raises(KeyError):
            s.registry.get("nope")
        s.add_model("m2", _jax_text(0))
        assert s.swap(_booster(1)._booster, model="m2") == 1
        assert np.array_equal(s.predict(X[:8], model="m2"),
                              _scores(_jax_text(1), X[:8]))
        assert s.generation == 0                      # default untouched
        assert np.array_equal(s.predict(X[:8]), _scores(_jax_text(0), X[:8]))
        with pytest.raises(ValueError, match="already registered"):
            s.add_model("m2", _jax_text(0))
        assert s.models() == ["default", "m2"]
        assert s.stats_snapshot()["registry"]["models"]["m2"][
            "generation"] == 1
    finally:
        s.close()


def test_failed_swaps_roll_back_then_breaker_rejects(tmp_path):
    X, _ = _data(0)
    ref = _scores(_jax_text(0), X[:8])
    bst = lgt.Booster(model_str=_jax_text(0), params={
        **CPU, "serve_swap_breaker": 2})
    s = bst.as_server(buckets=(8,), warmup=False, raw_score=True)
    try:
        with pytest.raises(SwapFailed):
            s.swap("tree\nversion=v4\nthis is not a model\n")
        assert s.generation == 0
        assert np.array_equal(s.predict(X[:8]), ref)
        with pytest.raises(SwapFailed):
            s.swap(str(tmp_path / "missing.txt"))
        assert s.health.state() == "degraded"
        with pytest.raises(SwapRejected):              # circuit open
            s.swap(_jax_text(1))
        assert s.stats_snapshot()["health"]["swap_breaker"] == "open"
        assert np.array_equal(s.predict(X[:8]), ref)   # still serving
        snap = s.stats_snapshot()
        assert (snap["swaps"], snap["swap_failures"]) == (0, 2)
    finally:
        s.close()
    # the probe after the cooldown, on the registry's injected clock
    t = [0.0]
    stats = ServeStats()
    reg = ModelRegistry(_port_build, stats=stats, breaker_threshold=2,
                        device=torch.device("cpu"), clock=lambda: t[0])
    reg.install("default", _jax_text(0), params=CPU)
    breaker = reg.entry("default").breaker
    health = HealthMonitor(breaker=breaker)
    for _ in range(2):
        with pytest.raises(SwapFailed):
            reg.swap("default", "not a model\n", params=CPU)
    with pytest.raises(SwapRejected):
        reg.swap("default", _jax_text(1), params=CPU)
    assert health.state() == "degraded"
    t[0] += breaker.cooldown_s                         # probe admitted
    assert breaker.state() == "half_open"
    assert reg.swap("default", _jax_text(1), params=CPU) == 1
    assert breaker.state() == "closed" and health.state() == "ok"
    snap = stats.snapshot()
    assert (snap["swaps"], snap["swap_failures"]) == (1, 2)


def test_swap_from_another_device_fails():
    s = _server()
    try:
        meta = lgt.Booster(model_str=_jax_text(1), params=CPU)._booster
        meta.device = torch.device("meta")             # a forest elsewhere
        with pytest.raises(SwapFailed, match="instead of moving it"):
            s.swap(meta)
        assert s.generation == 0
        # text loads on the server's device, whatever the default is
        gb = load_booster(_jax_text(1), {"verbose": -1}, torch.device("cpu"))
        assert gb.device.type == "cpu"
    finally:
        s.close()


def test_delta_swap_serves_the_full_forest_and_stale_delta_fails():
    X, _ = _data(0)
    full = _jax_text(0)
    base = _head(full, 5)
    s = lgt.Booster(model_str=base, params=CPU).as_server(
        buckets=(8, 64), warmup=False, raw_score=True)
    try:
        frame = delta.make_delta(s.model_text(), full)
        assert s.swap_delta(frame) == 1
        assert np.array_equal(s.predict(X[:64]), _scores(full, X[:64]))
        with pytest.raises(SwapFailed):                # base moved on
            s.swap_delta(frame)
        assert s.generation == 1
        assert s.stats_snapshot()["swap_failures"] == 1
    finally:
        s.close()


def test_swap_controller_flips_and_rolls_back():
    stats = ServeStats()
    sc = SwapController(_port_build, stats=stats,
                        breaker=CircuitBreaker(threshold=1),
                        device=torch.device("cpu"))
    assert sc.install(_booster(0)._booster) == 0
    t = sc.swap(_jax_text(1), params=CPU, background=True)
    t.join(60)
    assert not t.is_alive() and sc.active.generation == 1
    with pytest.raises(SwapFailed):
        sc.swap("not a model\n", params=CPU)
    with pytest.raises(SwapRejected):
        sc.swap(_jax_text(0), params=CPU)
    assert sc.active.generation == 1 and stats.snapshot()["swaps"] == 1


def test_hbm_budget_knob_binds_and_evicts():
    bst = lgt.Booster(model_str=_jax_text(0), params={
        **CPU, "serve_hbm_budget_mb": 1e-3})          # ~1 KB: one model
    with bst.as_server(buckets=(8,), warmup=False) as s:
        assert s.registry.hbm_budget_bytes == int(1e-3 * (1 << 20))
        s.add_model("m2", _jax_text(1))
        snap = s.stats_snapshot()
        assert snap["evictions"] == 1
        assert not snap["registry"]["models"]["default"]["resident"]


def test_hot_swap_under_load_never_tears_a_generation():
    X, _ = _data(0)
    texts = [_jax_text(0), _jax_text(1, rounds=6)]
    oracle = [_scores(t, X) for t in texts]
    assert not np.array_equal(oracle[0], oracle[1])
    s = _server(buckets=(1, 8, 64), max_delay_ms=1.0, workers=2,
                raw_score=True)
    failures, served = [], [0] * 4
    swaps_done = threading.Event()

    def client(tid):
        rs = np.random.RandomState(100 + tid)
        while served[tid] < 50 or (not swaps_done.is_set()
                                   and served[tid] < 400):
            n = int(rs.choice([1, 3, 16]))
            i = int(rs.randint(0, X.shape[0] - n))
            res = s.submit(X[i:i + n]).result(timeout=60)
            served[tid] += 1
            if not np.array_equal(res.values,
                                  oracle[res.generation % 2][i:i + n]):
                failures.append((tid, i, n, res.generation))

    clients = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    try:
        for c in clients:
            c.start()
        for g in range(1, 7):
            assert s.swap(texts[g % 2]) == g
        swaps_done.set()
        for c in clients:
            c.join(120)
        assert not any(c.is_alive() for c in clients)
    finally:
        swaps_done.set()
        s.close()
    assert not failures, failures[:3]
    assert sum(served) >= 200
    assert s.stats_snapshot()["swaps"] == 6


def test_source_key_is_kept_until_the_trees_change():
    """The artifact store's key of a held booster equals the JAX package's
    before and after an in-place leaf edit, and a rollback's; it is kept
    between lookups only while the trees are the same."""
    from lambdagap_tpu.infer import source_key_of as jax_key
    from lambdagap_tpu_torch.infer import source_key_of
    text = _jax_text(0)
    ours = lgt.Booster(model_str=text, params=CPU)
    theirs = lgb.Booster(model_str=text, params=JAX)
    first = source_key_of(ours._booster)
    assert first == source_key_of(ours._booster) == jax_key(theirs._booster)
    for b in (ours, theirs):
        b.set_leaf_output(3, 1, 0.25)
    edited = source_key_of(ours._booster)
    assert edited != first and edited == jax_key(theirs._booster)
    ours._booster.models.pop()                     # a tree fewer
    theirs._booster.models.pop()
    assert source_key_of(ours._booster) == jax_key(theirs._booster) != edited
