"""Cross-model packing in the port against the JAX package's.

On the CPU, with the three models of ``tests/test_infer.py``'s pack test
(binary with 15 leaves, regression on 6 columns, 3-class on 8 columns):
the port's ``ModelPack.predict_mixed`` is ``array_equal`` to the JAX
package's (its Pallas kernel in interpret mode) on the same texts and
parts, and to each member's own cache; ``pack_buffers`` merges the
members' node records group for group; ``PackedForests`` of one member
equals the unpacked dispatch; the packed plain version equals each member
alone when a row tile and a block's 8 groups straddle members; the packed
maps and early stop are refused; and ``ForestServer`` under
``serve_pack_models`` serves a mixed batch as one packed dispatch per
bucket, each tenant's rows equal to its solo cache, refuses a model that
cannot pack (and a memory budget) when it is added or swapped in, and
stamps every answer of a hot-swap storm with the generation whose pack
computed it.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools
import threading

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.serve.cache import CompiledForestCache as JaxCache
from lambdagap_tpu.serve.cache import ModelPack as JaxPack
from lambdagap_tpu_torch.guard.degrade import SwapFailed
from lambdagap_tpu_torch.infer import engine as eng
from lambdagap_tpu_torch.serve.cache import CompiledForestCache, ModelPack

CPU = {"device_type": "cpu", "verbose": -1, "predict_engine": "compiled"}
JAX = {"verbose": -1, "tpu_fast_predict_rows": 0,
       "predict_engine": "compiled"}


def _data(rows=700, feats=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan                    # exercises default-left routing
    y = (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0)
    return X, y.astype(np.float32)


def _train(params, X, y, rounds):
    return lgb.train({**JAX, **params}, lgb.Dataset(X, label=y),
                     num_boost_round=rounds).model_to_string()


@functools.lru_cache(maxsize=None)
def _texts():
    """The three members of the JAX package's pack test, as model text."""
    X, y = _data()
    rng = np.random.RandomState(9)
    X3 = rng.randn(700, 8).astype(np.float32)
    y3 = (X3[:, 0] > 0).astype(int) + (X3[:, 1] > 0.5)
    return {
        "a": _train({"objective": "binary", "num_leaves": 15}, X, y, 8),
        "b": _train({"objective": "regression", "num_leaves": 7}, X[:, :6],
                    X[:, 0] * 2.0, 5),
        "c": _train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": 15}, X3, y3, 6),
    }, X, X3


def _port_caches(**extra):
    texts = _texts()[0]
    return {n: CompiledForestCache(lgt.Booster(
        model_str=t, params={**CPU, **extra})._booster)
        for n, t in texts.items()}


def _parts():
    _, X, X3 = _texts()
    return [("a", X[:37], False), ("b", X[37:60, :6], False),
            ("c", X3[:25], False), ("a", X[60:61], True),
            ("c", X3[25:300], True), ("b", X[300:301, :6], True)]


def test_model_pack_equals_jax_pack_and_each_member():
    """Raw scores (the forest-order sums) equal the JAX pack's; converted
    outputs (the two libraries' ``exp`` may part by an ulp) equal the
    port's own member caches."""
    caches = _port_caches()
    pack = ModelPack(caches, buckets=(8, 64, 512))
    assert pack.warm() > 0 and not pack._warm - {8, 64, 512}
    assert [caches["a"].bucket_of(n) for n in (1, 9, 9000)] == [1, 64, 4096]
    outs = pack.predict_mixed(_parts())
    for (name, Xp, raw), got in zip(_parts(), outs):
        assert np.array_equal(got, caches[name].predict(Xp, raw_score=raw))
    raw_parts = [(n, Xp, True) for n, Xp, _ in _parts()]
    jax_caches = {n: JaxCache(lgb.Booster(model_str=t, params=JAX)._booster)
                  for n, t in _texts()[0].items()}
    jax_outs = JaxPack(jax_caches, buckets=(8, 64, 512)).predict_mixed(
        raw_parts)
    for (name, _, _), got, want in zip(raw_parts,
                                       pack.predict_mixed(raw_parts),
                                       jax_outs):
        assert got.shape == want.shape and np.array_equal(got, want), name
    assert pack.hbm_bytes > max(c.hbm_bytes for c in caches.values())


def test_pack_buffers_merge_member_records():
    caches = _port_caches()
    arts = [c.artifact for c in caches.values()]
    merged, group_model = eng.pack_buffers([a.buffers for a in arts])
    rec, gnl, groot, gsteps = eng.node_records(merged)
    parts = [eng.node_records(a.buffers) for a in arts]
    G = [p[2].shape[0] for p in parts]
    assert np.array_equal(group_model, np.repeat(np.arange(3), G))
    assert np.array_equal(groot, np.concatenate([p[2] for p in parts]))
    assert np.array_equal(gsteps, np.concatenate([p[3] for p in parts]))
    assert np.array_equal(np.diff(gnl), np.concatenate(
        [np.diff(p[1]) for p in parts]))
    cat_rows = np.cumsum([0] + [a.buffers["cat_table"].shape[0]
                                for a in arts])
    for i, p in enumerate(parts):
        lo, hi = gnl[sum(G[:i])], gnl[sum(G[:i + 1])]
        got = rec[lo:hi].copy()
        cat = (got[:, 1] & 8) != 0
        got[cat, 0] -= cat_rows[i]         # bitset rows shift per member
        assert np.array_equal(got, p[0])


def test_one_member_pack_equals_unpacked_dispatch():
    _, X, _ = _texts()
    cf = _port_caches()["a"]._compiled
    packed = eng.PackedForests({"a": cf})
    x = torch.from_numpy(X[:300])
    got = packed.predict(x, np.zeros(300, np.int32))
    assert torch.equal(got, cf.predict(x))


def test_packed_plain_version_straddles_tiles_and_blocks():
    """A 300-row batch whose 256-row tiles hold rows of every member, over
    8-group blocks of which one holds groups of two members: each row
    equals its member alone, through the public wrapper's map checks."""
    caches = _port_caches()
    cfs = {n: c._compiled for n, c in caches.items()}
    packed = eng.PackedForests(cfs)
    gm = packed._group_model.tolist()
    assert any(len(set(gm[i:i + 8])) > 1 for i in range(0, len(gm), 8))
    _, X, X3 = _texts()
    rng = np.random.RandomState(3)
    rm = rng.randint(0, 3, 300).astype(np.int32)
    x = np.full((300, packed.width), np.nan, np.float32)
    x[rm != 2] = X[:300][rm != 2, :packed.width]
    x[rm == 2, :8] = X3[:300][rm == 2]
    xt = torch.from_numpy(x)
    t = packed.tables
    got = eng.predict_forest(xt, t, t.group_tree_lo, t.group_tree,
                             packed._leaf_value, packed._tree_class, 3, 0,
                             0.0, torch.from_numpy(rm), packed._group_model)
    assert torch.equal(got, packed.predict(xt, rm))
    for i, (name, cf) in enumerate(cfs.items()):
        rows = np.nonzero(rm == i)[0]
        solo = cf.predict(xt[rows, :cf.width])
        assert torch.equal(got[:cf.num_class, rows], solo), name
        assert not got[cf.num_class:, rows].any()   # extra classes stay 0


def test_packed_maps_and_early_stop_are_refused():
    caches = _port_caches()
    packed = eng.PackedForests({n: c._compiled for n, c in caches.items()})
    t = packed.tables
    x = torch.zeros((4, packed.width))
    args = (x, t, t.group_tree_lo, t.group_tree, packed._leaf_value,
            packed._tree_class, 3)
    bad = torch.tensor([0, 1, 3, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="row_model holds members"):
        eng.predict_forest(*args, 0, 0.0, bad, packed._group_model)
    with pytest.raises(ValueError, match="row_model holds members"):
        packed.predict(x, bad.numpy())
    with pytest.raises(ValueError, match="come together"):
        eng.predict_forest(*args, 0, 0.0, bad, None)
    with pytest.raises(ValueError, match="early stop"):
        eng.predict_forest(*args, 2, 0.5, torch.zeros(4, dtype=torch.int32),
                           packed._group_model)
    es = _port_caches(pred_early_stop=True, pred_early_stop_freq=2)
    with pytest.raises(ValueError, match="early stop"):
        ModelPack({"es": es["a"]})
    with pytest.raises(ValueError, match="early stop"):
        eng.PackedForests({"es": es["a"]._compiled})


def test_server_packs_a_mixed_batch_into_one_dispatch():
    texts, X, X3 = _texts()
    bst = lgt.Booster(model_str=texts["a"],
                      params={**CPU, "serve_pack_models": True})
    s = bst.as_server(buckets=(8, 32), warmup=False, max_delay_ms=200.0,
                      workers=1)
    try:
        s.add_model("t2", texts["b"])
        s.add_model("t3", texts["c"])
        before = s.stats_snapshot()["cache"]["packed_dispatches"]
        futs = [s.submit(X[:13]), s.submit(X[13:20, :6], model="t2"),
                s.submit(X3[20:31], model="t3")]
        outs = [f.result(60) for f in futs]
        snap = s.stats_snapshot()
        # 31 rows: one 32-row bucket, one packed dispatch
        assert snap["cache"]["packed_dispatches"] == before + 1
        for (name, rows), res in zip((("default", X[:13]),
                                      ("t2", X[13:20, :6]),
                                      ("t3", X3[20:31])), outs):
            assert np.array_equal(res.values,
                                  s.registry.get(name).predict(rows))
    finally:
        s.close()


def test_server_refuses_a_member_that_cannot_pack():
    """Under serve_pack_models every model is served from the pack, so a
    model that cannot pack (prediction early stop, another engine) is
    refused when it is added or swapped in, never found at request time;
    so is a memory budget, which would evict a model the pack needs."""
    texts, X, _ = _texts()
    packing = {**CPU, "serve_pack_models": True}
    es = lgt.Booster(model_str=texts["a"], params={
        **CPU, "pred_early_stop": True, "pred_early_stop_freq": 2})
    scan = lgt.Booster(model_str=texts["b"], params={
        **CPU, "predict_engine": "scan"})
    with pytest.raises(ValueError, match="serve_hbm_budget_mb"):
        lgt.Booster(model_str=texts["a"], params={
            **packing, "serve_hbm_budget_mb": 64}).as_server(warmup=False)
    with pytest.raises(ValueError, match="early stop"):
        lgt.Booster(model_str=texts["a"], params={
            **packing, "pred_early_stop": True}).as_server(warmup=False)
    bst = lgt.Booster(model_str=texts["a"], params=packing)
    with bst.as_server(buckets=(8, 32), warmup=False, workers=1,
                       raw_score=True) as s:
        for name, member in (("es", es), ("scan", scan)):
            with pytest.raises(ValueError, match="serve_pack_models"):
                s.add_model(name, member)
        assert s.models() == ["default"]
        with pytest.raises(SwapFailed) as err:
            s.swap(es)
        assert isinstance(err.value.__cause__, ValueError)
        res = s.submit(X[:8]).result(60)
        assert res.generation == 0 and s.stats_snapshot()["cache"][
            "packed_dispatches"] == 1
        assert np.array_equal(res.values, s.registry.get("default").predict(
            X[:8], raw_score=True))


def test_packed_server_serves_the_swapped_in_forest():
    """A swap of a packed member rebuilds the pack: its rows then score
    as the new forest and carry the new generation. (The JAX package
    keys its pack on the booster's own generation, 0 for the swapped-in
    booster too, and keeps serving the old forest there.)"""
    texts, X, _ = _texts()
    bst = lgt.Booster(model_str=texts["a"],
                      params={**CPU, "serve_pack_models": True})
    with bst.as_server(buckets=(8, 32), warmup=False, workers=1,
                       raw_score=True) as s:
        s.add_model("t2", texts["b"])
        old = s.submit(X[:5, :6], model="t2").result(60)
        assert s.swap(texts["a"], model="t2") == 1
        new = s.submit(X[:5], model="t2").result(60)
        assert (old.generation, new.generation) == (0, 1)
        assert np.array_equal(new.values, s.registry.get("default").predict(
            X[:5], raw_score=True))
        assert not np.array_equal(new.values, old.values)
        assert s.stats_snapshot()["cache"]["packed_dispatches"] == 2


def test_packed_hot_swap_under_load_never_tears_a_generation():
    """Four threads send mixed batches to two packed models while one of
    them swaps 6 times between two forests: every answer equals the solo
    cache of the generation it reports, so the pack that computed it and
    the generation stamped on it are one."""
    texts, X, _ = _texts()
    forests = [texts["b"], texts["a"]]                 # t2's generations
    oracle = {"default": [CompiledForestCache(lgt.Booster(
        model_str=texts["a"], params=CPU)._booster).predict(
            X, raw_score=True)] * 2,
        "t2": [CompiledForestCache(lgt.Booster(
            model_str=t, params=CPU)._booster).predict(X, raw_score=True)
            for t in forests]}
    assert not np.array_equal(oracle["t2"][0], oracle["t2"][1])
    bst = lgt.Booster(model_str=texts["a"],
                      params={**CPU, "serve_pack_models": True})
    s = bst.as_server(buckets=(1, 8, 64), warmup=False, max_delay_ms=1.0,
                      workers=2, raw_score=True)
    s.add_model("t2", forests[0])
    failures, served = [], [0] * 4
    swaps_done = threading.Event()

    def client(tid):
        rs = np.random.RandomState(200 + tid)
        while served[tid] < 50 or (not swaps_done.is_set()
                                   and served[tid] < 400):
            n = int(rs.choice([1, 3, 16]))
            i = int(rs.randint(0, X.shape[0] - n))
            name = "t2" if rs.rand() < 0.6 else "default"
            res = s.submit(X[i:i + n], model=name).result(timeout=60)
            served[tid] += 1
            want = oracle[name][res.generation % 2][i:i + n]
            if not np.array_equal(res.values, want):
                failures.append((tid, name, i, n, res.generation))

    clients = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    try:
        for c in clients:
            c.start()
        for g in range(1, 7):
            assert s.swap(forests[g % 2], model="t2") == g
        swaps_done.set()
        for c in clients:
            c.join(120)
        assert not any(c.is_alive() for c in clients)
    finally:
        swaps_done.set()
        s.close()
    assert not failures, failures[:3]
    assert sum(served) >= 200
    snap = s.stats_snapshot()
    assert snap["swaps"] == 6 and snap["errors"] == 0
    assert snap["cache"]["packed_dispatches"] > 0
    assert snap["registry"]["pack_hbm_bytes"] > 0


def test_a_swap_during_a_packed_batch_keeps_its_generation():
    """A swap that flips the pointer after a batch resolved its pack: the
    batch is computed by that pack and stamped with its generation, and
    the next batch serves the new forest under the new generation."""
    texts, X, _ = _texts()
    solo = {k: CompiledForestCache(lgt.Booster(
        model_str=texts[k], params=CPU)._booster).predict(
            X[:8], raw_score=True) for k in ("a", "b")}
    bst = lgt.Booster(model_str=texts["a"],
                      params={**CPU, "serve_pack_models": True})
    with bst.as_server(buckets=(8,), warmup=False, workers=1,
                       raw_score=True) as s:
        s.add_model("t2", texts["b"])
        resolve, swapped = s._model_pack, []

        def racing():
            pack = resolve()
            if not swapped:              # the flip lands mid-batch
                swapped.append(s.registry.swap("t2", texts["a"]))
            return pack

        s._model_pack = racing
        old = s.submit(X[:8], model="t2").result(60)
        s._model_pack = resolve
        new = s.submit(X[:8], model="t2").result(60)
    assert swapped == [1]
    assert old.generation == 0 and np.array_equal(old.values, solo["b"])
    assert new.generation == 1 and np.array_equal(new.values, solo["a"])
