"""The traversal kernel's node records and the accumulation wrapper, on the
CPU.

At upload the port re-lays each structure group's nodes contiguously as
16-byte records (threshold bits, ``feature << 4 | flags``, group-local
children; ``infer/engine.py`` ``node_records``). A plain walk of those
records (``_traverse_records_reference``, the kernel's walk in torch ops)
must give the node carry of the artifact's own block walk and of the JAX
package's ``_traverse_all`` (``array_equal``) on every case, 16,384-leaf
groups included; each record must decode back to its artifact node; the
accumulation wrapper on a CPU tensor must be the plain ``_leaf_values`` +
``_accumulate``, which equal the JAX package's ``lax.scan``, and must
refuse maps out of range. The artifact itself is never changed.
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
from lambdagap_tpu_torch.convert import booster_from_numpy
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.infer import engine as eng
from lambdagap_tpu_torch.infer.compile import FLAG_CATEGORICAL, FLAG_MT_SHIFT
from lambdagap_tpu_torch.models import synth

CPU = {"device_type": "cpu"}
HOSTILE = np.array([1e10, -1e10, -3.5, 70.9, np.nan, 69.0, 69.5, -0.5,
                    3e9, 0.0], np.float32)
CASES = ["binary_nan", "zero_as_missing", "multiclass",
         "categorical_hostile", "many_blocks", "merged"]


def _data(rows=601, feats=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    X[::7, 3] = np.nan
    X[::11] = np.nan
    return X, (X[:, 0] + 0.5 * X[:, 1] * np.nan_to_num(X[:, 2]) > 0
               ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX booster, rows, compile knobs) of one case, trained once."""
    X, y = _data()
    p = {"verbose": -1, "objective": "binary", "num_leaves": 15}
    knobs = {}
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
    elif case == "many_blocks":
        p.update(num_leaves=63)
        knobs = {"infer_node_block_kb": 1}
    b = lgb.train({**p, **knobs},
                  lgb.Dataset(X, label=y, categorical_feature=cats),
                  num_boost_round=100 if case == "many_blocks" else 8)
    if case == "merged":
        # iteration-tiled: 8 structures shared by 32 trees
        gb = b._booster
        gb.models = list(gb.host_models) * 4
        gb.iter_ = len(gb.models)
        gb.invalidate_predict_cache()
    if case == "categorical_hostile":
        X = X.copy()
        X[::2, 0] = HOSTILE[np.arange(0, len(X), 2) % len(HOSTILE)]
    return b, X, knobs


def _port(case):
    b, X, knobs = _case(case)
    port = lgt.Booster(model_str=b.model_to_string(),
                       params={**CPU, **knobs})
    art = compile_forest(port._booster)
    return art, eng.device_tables(art, torch.device("cpu")), X


@pytest.mark.parametrize("case", CASES)
def test_records_walk_equals_block_walk_and_jax(case):
    b, X, _knobs = _case(case)
    art, tables, _ = _port(case)
    if case == "many_blocks":
        assert art.meta["num_blocks"] > 1
    if case == "merged":
        assert art.meta["trees_merged"] > 0
    blocks, depths = jax_engine._device_blocks(jax_compile(b._booster).buffers)
    ref = np.asarray(jax_engine._traverse_all(jnp.asarray(X), blocks,
                                              depths, 256))
    x = torch.from_numpy(X)
    got = eng._traverse_records_reference(x, tables).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert np.array_equal(eng._traverse_all_reference(x, tables).numpy(), ref)
    assert (got < 0).all()


@pytest.mark.parametrize("case", CASES)
def test_records_decode_to_the_artifact_nodes(case):
    art, t, _ = _port(case)
    b = art.buffers
    rec = t.rec.numpy()
    gnl = t.group_node_lo.numpy().astype(np.int64)
    G = len(b["root"])
    assert rec.dtype == np.int32 and rec.shape == (len(b["node_feat"]), 4)
    assert gnl[0] == 0 and gnl[-1] == rec.shape[0] and len(gnl) == G + 1
    lo = np.asarray(b["block_node_lo"])
    glo = np.asarray(b["block_group_lo"])
    word1 = rec[:, 1].view(np.uint32)
    thr_tab = np.asarray(b["thr_table"], np.float32)
    seen = 0
    for blk in range(len(lo) - 1):
        for g in range(glo[blk], glo[blk + 1]):
            root = int(b["root"][g])
            if root < 0:                       # a stump: no records
                assert gnl[g + 1] == gnl[g] and t.group_root[g] == root
                assert t.group_steps[g] == 0
                continue
            assert t.group_root[g] == 0
            # breadth-first walk of the artifact's group against its records
            queue, local, levels = [root], {root: 0}, 0
            frontier = [root]
            while frontier:
                levels += 1
                nxt = []
                for n in frontier:
                    for c in (b["node_left"][lo[blk] + n],
                              b["node_right"][lo[blk] + n]):
                        if c >= 0:
                            local[int(c)] = len(queue)
                            queue.append(int(c))
                            nxt.append(int(c))
                frontier = nxt
            assert gnl[g + 1] - gnl[g] == len(queue)
            assert t.group_steps[g] == levels
            for n in queue:
                k = lo[blk] + n
                r = rec[gnl[g] + local[n]]
                flags = int(b["node_flags"][k])
                assert int(word1[gnl[g] + local[n]] >> 4) == \
                    int(b["node_feat"][k])
                assert int(word1[gnl[g] + local[n]] & 15) == flags
                if flags & FLAG_CATEGORICAL:
                    assert r[0] == int(b["node_cat"][k])
                else:
                    thr = np.asarray([r[0]], np.int32).view(np.float32)
                    assert thr.view(np.uint32)[0] == thr_tab[
                        int(b["node_thr"][k])].view(np.uint32)
                for j, side in ((2, "node_left"), (3, "node_right")):
                    c = int(b[side][k])
                    assert r[j] == (local[c] if c >= 0 else c)
            seen += len(queue)
    assert seen == rec.shape[0]
    assert ((word1 >> 4) < art.meta["width"]).all()
    assert (((word1 & 15) >> FLAG_MT_SHIFT) & 3 < 3).all()


def test_large_groups_records_walk_like_the_blocks():
    """synth's 16,384-leaf trees: each group's thousands of records,
    walked to depths far past a 255-leaf tree's, give the artifact's block
    walk."""
    trees = synth.random_trees(2, 2, 16384, 28)
    text = booster_from_numpy(synth.header(28), trees, CPU).model_to_string()
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    t = eng.device_tables(compile_forest(gb), torch.device("cpu"))
    assert t.group_root.shape == (2,)
    assert (np.diff(t.group_node_lo.numpy()) > 4096).all()
    x = torch.from_numpy(synth.random_rows(np.random.RandomState(0), 257, 28))
    assert torch.equal(eng._traverse_records_reference(x, t),
                       eng._traverse_all_reference(x, t))


def test_width_past_28_bits_raises():
    art, _t, _ = _port("binary_nan")
    wide = eng.ForestArtifact(meta={**art.meta, "width": eng.MAX_WIDTH},
                              buffers=art.buffers)
    with pytest.raises(NotImplementedError, match=str(eng.MAX_WIDTH)):
        eng.device_tables(wide, torch.device("cpu"))


@pytest.mark.parametrize("case", ["binary_nan", "multiclass", "merged"])
@pytest.mark.parametrize("es", [(0, 0.0), (3, 0.5)])
def test_accumulate_wrapper_on_cpu_equals_jax(case, es):
    """accumulate_forest on a CPU tensor is the plain version, counts no
    launch, and equals the JAX package's gather + lax.scan."""
    b, X, _ = _case(case)
    art, t, _ = _port(case)
    bufs = art.buffers
    K = int(art.meta["num_class"])
    carry = eng._traverse_all_reference(torch.from_numpy(X), t)
    freq = es[0] * K
    eng.ACCUMULATE_LAUNCHES.reset()
    got = eng.accumulate_forest(
        carry, torch.from_numpy(np.asarray(bufs["group_of_tree"], np.int32)),
        torch.from_numpy(np.asarray(bufs["leaf_value"], np.float32)),
        torch.from_numpy(np.asarray(bufs["tree_class"], np.int32)), K, freq,
        es[1]).numpy()
    assert eng.ACCUMULATE_LAUNCHES.launches == 0
    node = jnp.asarray(carry.numpy())
    vals = jax_engine._leaf_values(
        jnp.asarray(X), node, jnp.asarray(bufs["group_of_tree"]),
        (jnp.asarray(bufs["leaf_value"]),), False)
    R = X.shape[0]
    init = (jnp.zeros((K, R), jnp.float32), jnp.zeros(R, dtype=bool),
            jnp.int32(0))
    ref = np.asarray(jax_engine._accumulate(
        vals, jnp.asarray(bufs["tree_class"]), init, K, freq,
        jnp.float32(es[1]))[0])
    assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_non_cpu_tensor_never_reaches_the_plain_accumulation():
    """A carry on any non-CPU device goes to the kernel or raises: the
    wrapper has no fallback to the plain version."""
    art, t, X = _port("binary_nan")
    b = art.buffers
    carry = eng._traverse_all_reference(torch.from_numpy(X), t)
    args = [torch.from_numpy(np.asarray(b[k], dt)).to("meta") for k, dt in
            (("group_of_tree", np.int32), ("leaf_value", np.float32),
             ("tree_class", np.int32))]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        eng.accumulate_forest(carry.to("meta"), *args, 1, 0, 0.0)


@pytest.mark.parametrize("bad", ["group_high", "group_negative",
                                 "class_high", "class_negative"])
def test_maps_out_of_range_are_refused(bad):
    """A tree mapped past the carry's groups or the forest's classes is
    refused by the wrapper and by CompiledForest at upload: on the card the
    kernel would read or write out of bounds."""
    art, t, X = _port("multiclass")
    b = art.buffers
    K = int(art.meta["num_class"])
    carry = eng._traverse_all_reference(torch.from_numpy(X), t)
    gof = np.asarray(b["group_of_tree"], np.int32).copy()
    tc = np.asarray(b["tree_class"], np.int32).copy()
    if bad == "group_high":
        gof[-1] = carry.shape[1]
    elif bad == "group_negative":
        gof[0] = -1
    elif bad == "class_high":
        tc[1] = K
    else:
        tc[-1] = -1
    what = "group_of_tree" if bad.startswith("group") else "tree_class"
    with pytest.raises(ValueError, match=what):
        eng.accumulate_forest(
            carry, torch.from_numpy(gof),
            torch.from_numpy(np.asarray(b["leaf_value"], np.float32)),
            torch.from_numpy(tc), K, 0, 0.0)
    broken = eng.ForestArtifact(
        meta=art.meta,
        buffers={**b, "group_of_tree": gof, "tree_class": tc})
    with pytest.raises(ValueError, match=what):
        eng.CompiledForest(broken, torch.device("cpu"))
