"""The one-launch compiled dispatch (``predict_forest``) on the CPU.

At upload the port lists each structure group's trees as a CSR
(``group_tree_lo`` / ``group_tree``, the inverse of the artifact's
``group_of_tree``); the fused kernel's epilogue writes every tree of a
finished group through it. The CSR must hold every tree exactly once, in
forest order within its group, on merged, unmerged, multiclass and
stump-holding forests. ``predict_forest`` on a CPU tensor is the fused
kernel's phases in plain torch ops (the records walk, the workspace
through the CSR, the forest-order accumulation) and must give the JAX
package's compiled engine's raw scores (``array_equal``) with early stop
off and on, at row counts around the kernel's 256-row tile. It counts no
launch on the CPU, and refuses other devices and bad maps.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import functools

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.infer import compile_forest as jax_compile
from lambdagap_tpu.infer import engine as jax_engine
from lambdagap_tpu_torch.convert import booster_from_numpy
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.infer import engine as eng
from lambdagap_tpu_torch.models import synth
from lambdagap_tpu_torch.models.tree import Tree

CPU = {"device_type": "cpu"}
ROWS = (1, 255, 256, 257)      # straddle the fused kernel's 256-row tile
HOSTILE = np.array([1e10, -1e10, -3.5, 70.9, np.nan, 69.0, 69.5, -0.5,
                    3e9, 0.0], np.float32)


def _synth_forest(kind):
    """(trees, features, objective, compile knobs) of a seeded forest."""
    if kind == "merged":
        # 6 structures, each shared by 3 trees (leaf values differ)
        trees = synth.random_trees(1, 6, 15, 8, grid_size=20)
        for k, t in enumerate(trees[:]):
            for j in range(2):
                c = synth.random_trees(1, 6, 15, 8, grid_size=20)[k]
                c.leaf_value = c.leaf_value + 0.1 * (j + 1)
                trees.append(c)
        return trees, 8, "binary sigmoid:1", {}
    if kind == "unmerged":
        trees = synth.random_trees(2, 4, 15, 8, grid_size=20) * 3
        return trees, 8, "binary sigmoid:1", {"infer_merge_trees": False}
    if kind == "multiclass":
        return (synth.random_trees(3, 12, 7, 8, grid_size=4), 8,
                "multiclass num_class:3", {})
    stump = Tree(max_leaves=1)
    stump.leaf_value[0] = 0.25
    other = Tree(max_leaves=1)
    other.leaf_value[0] = -0.5
    trees = synth.random_trees(4, 5, 15, 8, grid_size=20)
    return trees[:2] + [stump] + trees[2:] + [other], 8, \
        "binary sigmoid:1", {}


@pytest.mark.parametrize("kind", ["merged", "unmerged", "multiclass",
                                  "stump"])
def test_group_tree_csr_lists_every_tree_once_in_forest_order(kind):
    trees, feats, obj, knobs = _synth_forest(kind)
    text = booster_from_numpy(synth.header(feats, obj), trees,
                              CPU).model_to_string()
    gb = lgt.Booster(model_str=text, params={**CPU, **knobs})._booster
    art = compile_forest(gb)
    t = eng.device_tables(art, torch.device("cpu"))
    gof = np.asarray(art.buffers["group_of_tree"], np.int64)
    lo, gt = t.group_tree_lo.numpy(), t.group_tree.numpy()
    G, T = t.group_root.shape[0], len(trees)
    assert lo.dtype == np.int32 and gt.dtype == np.int32
    assert lo.shape == (G + 1,) and gt.shape == (T,)
    assert lo[0] == 0 and lo[-1] == T and (np.diff(lo) >= 0).all()
    assert np.array_equal(np.sort(gt), np.arange(T))
    for g in range(G):
        mine = gt[lo[g]:lo[g + 1]]
        assert np.array_equal(mine, np.nonzero(gof == g)[0])  # forest order
    if kind == "merged":
        assert G == 6 and (np.diff(lo) == 3).all()
    if kind == "unmerged":
        assert G == T and (np.diff(lo) == 1).all()
    if kind == "stump":
        stumps = np.nonzero(t.group_root.numpy() < 0)[0]
        assert len(stumps) == 1
        g = stumps[0]
        assert gt[lo[g]:lo[g + 1]].tolist() == [2, T - 1]
        x = torch.from_numpy(synth.random_rows(np.random.RandomState(0),
                                               33, feats))
        want = lgt.Booster(model_str=text, params={
            **CPU, "predict_engine": "scan"}).predict(x.numpy(),
                                                      raw_score=True)
        cf = eng.CompiledForest(art, torch.device("cpu"))
        assert np.array_equal(cf.predict(x)[0].numpy(), want)


def test_group_trees_refuses_a_tree_outside_the_groups():
    with pytest.raises(ValueError, match="group_of_tree"):
        eng.group_trees(np.array([0, 2, 1], np.int32), 2)
    with pytest.raises(ValueError, match="group_of_tree"):
        eng.group_trees(np.array([0, -1], np.int32), 2)


def _data(rows=601, feats=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    X[::11] = np.nan
    return X, (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0
               ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX booster, 257 rows) of one case, trained once."""
    X, y = _data()
    p = {"verbose": -1, "objective": "binary", "num_leaves": 15}
    cats = "auto"
    if case == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
        p.update(objective="multiclass", num_class=3)
    elif case == "categorical":
        rng = np.random.RandomState(3)
        X[:, 0] = rng.randint(0, 70, size=X.shape[0]).astype(np.float32)
        y = ((X[:, 0].astype(int) % 5 < 2) ^ (X[:, 1] > 0)
             ).astype(np.float32)
        p.update(num_leaves=31, min_data_per_group=5)
        cats = [0]
    b = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=cats),
                  num_boost_round=8)
    if case == "merged":
        # iteration-tiled: 8 structures shared by 32 trees
        gb = b._booster
        gb.models = list(gb.host_models) * 4
        gb.iter_ = len(gb.models)
        gb.invalidate_predict_cache()
    X = X[:max(ROWS)].copy()
    if case == "categorical":
        X[::2, 0] = HOSTILE[np.arange(0, len(X), 2) % len(HOSTILE)]
    return b, X


@functools.lru_cache(maxsize=None)
def _jax_scores(case, early_stop):
    """The JAX package's compiled engine on all 257 rows (rows never
    interact, so its first n rows are its answer for n rows), and the
    early-stop (freq, margin): one round, half the median final margin."""
    b, X = _case(case)
    art = jax_compile(b._booster)
    K = int(art.meta["num_class"])
    freq, margin = 0, 0.0
    if early_stop:
        full = np.asarray(jax_engine.CompiledForest(art).predict(X))
        top2 = np.sort(full, axis=0)[-2:] if K > 1 else None
        final = 2 * np.abs(full[0]) if K == 1 else top2[1] - top2[0]
        freq, margin = K, 0.5 * float(np.median(final))
    cf = jax_engine.CompiledForest(art, early_stop_freq=freq,
                                   early_stop_margin=margin)
    return np.asarray(cf.predict(X)), freq, margin


@pytest.mark.parametrize("case", ["binary_nan", "multiclass", "merged",
                                  "categorical"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_predict_forest_on_cpu_equals_jax_compiled(case, early_stop):
    b, X = _case(case)
    ref, freq, margin = _jax_scores(case, early_stop)
    if early_stop:   # the replay stops some rows
        assert not np.array_equal(ref, _jax_scores(case, False)[0])
    port = lgt.Booster(model_str=b.model_to_string(), params=CPU)
    art = compile_forest(port._booster)
    if case == "merged":
        assert art.meta["trees_merged"] > 0
    t = eng.device_tables(art, torch.device("cpu"))
    bufs = art.buffers
    leaf = torch.from_numpy(np.asarray(bufs["leaf_value"], np.float32))
    tc = torch.from_numpy(np.asarray(bufs["tree_class"], np.int32))
    K = int(art.meta["num_class"])
    eng.PREDICT_LAUNCHES.reset()
    for n in ROWS:
        got = eng.predict_forest(torch.from_numpy(X[:n]), t,
                                 t.group_tree_lo, t.group_tree, leaf, tc, K,
                                 freq, margin).numpy()
        assert got.dtype == np.float32 and got.shape == (K, n)
        assert np.array_equal(got, ref[:, :n]), n
    assert eng.PREDICT_LAUNCHES.launches == 0
    cf = eng.CompiledForest(art, torch.device("cpu"), early_stop_freq=freq,
                            early_stop_margin=margin)
    assert np.array_equal(cf.predict(torch.from_numpy(X)).numpy(), ref)
    assert eng.PREDICT_LAUNCHES.launches == 0


def _port_tables(case="multiclass"):
    b, X = _case(case)
    art = compile_forest(lgt.Booster(model_str=b.model_to_string(),
                                     params=CPU)._booster)
    t = eng.device_tables(art, torch.device("cpu"))
    leaf = torch.from_numpy(np.asarray(art.buffers["leaf_value"],
                                       np.float32))
    tc = torch.from_numpy(np.asarray(art.buffers["tree_class"], np.int32))
    return t, leaf, tc, int(art.meta["num_class"]), torch.from_numpy(X)


def test_non_cpu_tensor_never_reaches_the_plain_predict():
    """Rows on any non-CPU device go to the kernel or raise: the wrapper
    has no fallback to the plain version."""
    t, leaf, tc, K, x = _port_tables()
    meta = [a.to("meta") for a in (t.group_tree_lo, t.group_tree, leaf, tc)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        eng.predict_forest(x.to("meta"), t, *meta, K, 0, 0.0)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        eng._predict_forest(x.to("meta"), t, *meta, K, 0, 0.0)


@pytest.mark.parametrize("bad", ["tree_twice", "lo_short", "class_high",
                                 "class_negative"])
def test_predict_forest_refuses_bad_maps(bad):
    """A CSR that is not every tree once, or a class past the forest's,
    is refused: on the card the kernel would write out of bounds."""
    t, leaf, tc, K, x = _port_tables()
    lo, gt, tc = t.group_tree_lo.clone(), t.group_tree.clone(), tc.clone()
    if bad == "tree_twice":
        gt[1] = gt[0]
    elif bad == "lo_short":
        lo[-1] -= 1
    elif bad == "class_high":
        tc[1] = K
    else:
        tc[-1] = -1
    what = "tree_class" if bad.startswith("class") else "group_tree"
    with pytest.raises(ValueError, match=what):
        eng.predict_forest(x, t, lo, gt, leaf, tc, K, 0, 0.0)
