"""The port's CUDA kernels and the paths around them, on seeded synthetic
forests and data (no JAX: this file also runs on the card machine).

On the CPU: the plain traversal's leaf indices equal an independent
host walk of every tree (``Tree._decision``), and the compiled engine
equals the scan oracle bit for bit, hostile categorical values included.
On the card (``-m cuda``; skipped elsewhere): the traversal kernel (K3)
equals its plain version with ``torch.equal`` at the serving bucket sizes,
for numeric and categorical forests and one of two 16,384-leaf trees, and
counts one launch per call; the accumulation kernel equals the plain leaf
gather + forest-order loop with ``torch.equal`` for 1, 3, 7 and 20 classes
(one score in a register, more in shared memory), early stop off and on,
and refuses maps out of range; the fused kernel (K3's walk, the leaf
values and the accumulation in one launch) equals its plain version with
``torch.equal`` on merged, categorical, 16,384-leaf, 3-class and 20-class
forests at 1 to 4,096 rows, early stop off and on, reruns and a row alone
bit-identically, leaves its counters at zero (also after three
dispatches queued back to back) and gives two streams at once their own
counters; its packed mode (several forests merged, a member index a row)
equals its plain version and each member's own launch row by row, on
packs whose 8-group blocks and 256-row tiles straddle members and on one
with a 136-column member (no row staging), and null maps leave the
unpacked launch as it was; a compiled dispatch on the card is one launch of the fused
kernel and none of K3 or the accumulation alone; the compiled engine
and the server on the card equal the scan oracle on the card; the f32
histogram kernel (K1)
is ``torch.equal`` to its plain version on every channel at chip_smoke's
shapes (a skewed and an extreme-gradient leaf among them) and at
MSLR-WEB30K's 136 features (several feature tiles), with and without an
in-bag mask, reruns bit-identically and refuses bad inputs; the
int8 histogram kernel (K2) is ``torch.equal`` to its plain version at six
shapes (a saturated and a skewed one among them) and on a rerun; both
read a leaf through an offset into its parent's slice exactly as through
the slice itself, read a window of leaf-ordered copies (no row list,
tree_layout=sorted: the root, a 41,176-row leaf at an offset, masked, u16,
empty) equal to their plain versions and to the same leaf gathered
through the permutation, and give every host thread its own sums when two
build histograms at once on one stream; tree_layout=sorted trains on the
card to gather's model byte for byte (f32, quantized + bagged, the serial
learner), every histogram a window launch; the threefry draws and the quantized
levels on the card equal the CPU's bit for bit; and short trainings on the
card (f32,
quantized + bagging, GOSS, EFB, rankers: lambdarank targets,
rank_xendcg, positions with by-query bagging; and the objectives of the
multiclass slice: 7-class softmax with a categorical column, one-vs-all,
multiclass GOSS, the renewed L1 family, the log-link losses and weighted
cross_entropy_lambda; the host-driven serial learner with lazy CEGB,
bagging and advanced monotone constraints, whose unpaid-row counts on the
card equal a numpy count) equal the same on the CPU, and a 7-class model
served on the card with early stop equals the scan oracle. TreeSHAP's
kernel S equals its plain version at rtol 1e-9 / atol 1e-12 on numeric
(NaN and zero rows), 3-class and categorical forests, on one row, on
255-leaf trees at MSLR-WEB30K's 136 features, at 4,000 features (the
partials in the workspace, not shared memory), on a 16,384-leaf tree whose
longest merged path is near the 256-element cap and on a forest mixing
that tree with ordinary ones (the grouped and the long-path kernels in
one call), reruns bit-identically and counts one launch a call; a row's
contributions are ``torch.equal`` in any batch and whether the batch runs
in one pass or several; S's division by a reciprocal equals ``/`` bit for
bit on every divisor of its table and on arbitrary ones;
``pred_leaf`` under the compiled engine on the card is one traversal
launch and equals the tensor engine's leaves; ``predict_engine=tensor`` on
the card serves the scan oracle's scores. A DART round on the card builds
each histogram in one K1 launch, ``torch.equal`` to the plain version on
the round's own inputs, and a served DART model is one fused launch a
dispatch, ``torch.equal`` to the fused kernel's plain version. The fused
kernel's linear mode (linear leaves) is ``torch.equal`` to its plain
version (``ops/linear.linear_leaf_values``) on NaN rows, with the rows
staged and from global memory, solo and packed with constant members, and
reruns bit-identically.

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import copy
import functools

import numpy as np
import pytest
import torch

import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.convert import booster_from_numpy
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.infer import engine as eng
from lambdagap_tpu_torch.models import synth

CPU = {"device_type": "cpu"}


@functools.lru_cache(maxsize=None)
def _forest(kind):
    """(text, trees, features) of one synthetic forest, via the text
    round trip; "large": two 16,384-leaf trees, deep walks over groups of
    16,383 records each; "merged": 12 structures of 3 trees each; "mslr":
    20 trees at MSLR-WEB30K's 136 features;
    "multiclass" / "multiclass20": 8 rounds of 3 / 20 classes."""
    objective = "binary sigmoid:1"
    if kind == "numeric":
        trees, feats = synth.random_trees(3, 12, 31, 10, grid_size=40), 10
    elif kind == "merged":
        trees, feats = [], 10
        for j in range(3):
            for t in synth.random_trees(3, 12, 31, 10, grid_size=40):
                t.leaf_value = t.leaf_value * (j + 1) - 0.01 * j
                trees.append(t)
    elif kind == "large":
        trees, feats = synth.random_trees(2, 2, 16384, 28), 28
    elif kind == "mslr":
        trees, feats = synth.random_trees(5, 20, 63, 136), 136
    elif kind.startswith("multiclass"):
        K = 20 if kind == "multiclass20" else 3
        trees, feats = synth.random_trees(6, 8 * K, 15, 10, grid_size=3), 10
        objective = f"multiclass num_class:{K}"
    else:
        feats = 6
        trees = synth.categorical_trees(4, num_features=feats)
    text = booster_from_numpy(synth.header(feats, objective), trees,
                              CPU).model_to_string()
    return text, lgt.Booster(model_str=text, params=CPU)._booster.models, \
        feats


def _rows(kind, n, feats, seed=0):
    rng = np.random.RandomState(seed)
    if kind != "categorical":
        return synth.random_rows(rng, n, feats)
    return synth.hostile_rows(rng, n, feats)


def _host_leaf(tree, row):
    if tree.num_leaves == 1:
        return 0
    node = 0
    while node >= 0:
        node = tree._decision(row, node)
    return ~node


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_plain_traversal_leaves_equal_host_walk(kind):
    text, trees, feats = _forest(kind)
    X = _rows(kind, 301, feats)
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    art = compile_forest(gb)
    tables = eng.device_tables(art, torch.device("cpu"))
    carry = eng._traverse_all_reference(torch.from_numpy(X), tables).numpy()
    leaves = ~carry[:, np.asarray(art.buffers["group_of_tree"])]
    X64 = X.astype(np.float64)
    want = np.array([[_host_leaf(t, r) for t in trees] for r in X64])
    assert np.array_equal(leaves, want)


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
@pytest.mark.parametrize("infer", [{}, {"infer_prune": False},
                                   {"infer_merge_trees": False},
                                   {"infer_node_block_kb": 1}])
def test_compiled_equals_scan_on_cpu(kind, infer):
    text, trees, feats = _forest(kind)
    X = _rows(kind, 257, feats, seed=1)
    got = lgt.Booster(model_str=text, params={**CPU, **infer}).predict(
        X, raw_score=True)
    ref = lgt.Booster(model_str=text, params={**CPU, "predict_engine":
                                              "scan"}).predict(
        X, raw_score=True)
    assert np.array_equal(got, ref)
    host = np.array([sum(t.predict_row(r) for t in trees)
                     for r in X.astype(np.float64)])
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "categorical", "large"])
@pytest.mark.parametrize("rows", [1, 8, 63, 64, 601, 4096])
def test_kernel_equals_plain_version_on_card(kind, rows, cuda_device):
    text, _trees, feats = _forest(kind)
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    tables = eng.device_tables(compile_forest(gb), cuda_device)
    x = torch.from_numpy(_rows(kind, rows, feats)).to(cuda_device)
    ref = eng._traverse_all_reference(x, tables)
    before = eng.TRAVERSE_LAUNCHES.launches
    got = eng.traverse_forest(x, tables)
    torch.cuda.synchronize()
    assert eng.TRAVERSE_LAUNCHES.launches == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


def _accumulate_case(num_class, rows, dev, seed=0):
    """A seeded carry of 40 trees per class over fewer groups (trees share
    groups, some carries not ~leaf) with leaf values of mixed signs and
    zeros, so the f32 order and the +0.0 adds both show."""
    rng = np.random.RandomState(seed + num_class)
    T, G, L = 40 * num_class, 25 * num_class, 31
    carry = ~rng.randint(0, L, size=(rows, G)).astype(np.int32)
    carry[rng.rand(rows, G) < 0.02] = 3               # not a leaf: adds 0
    leaf = (rng.randn(T, L) * 0.7).astype(np.float32)
    leaf[rng.rand(T, L) < 0.1] = -0.0
    gof = rng.randint(0, G, size=T).astype(np.int32)
    tc = (np.arange(T) % num_class).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (carry, gof, leaf, tc)]


@pytest.mark.cuda
@pytest.mark.parametrize("num_class", [1, 3, 7, 20])   # each score layout
@pytest.mark.parametrize("es", [(0, 0.0), (3, 0.5)])
@pytest.mark.parametrize("rows", [1, 97, 4096])
def test_accumulate_kernel_equals_plain_version_on_card(num_class, es, rows,
                                                        cuda_device):
    carry, gof, leaf, tc = _accumulate_case(num_class, rows, cuda_device)
    freq = es[0] * num_class
    ref = eng._accumulate(eng._leaf_values(carry, gof, leaf), tc.tolist(),
                          num_class, freq, es[1])
    before = eng.ACCUMULATE_LAUNCHES.launches
    got = eng.accumulate_forest(carry, gof, leaf, tc, num_class, freq, es[1])
    torch.cuda.synchronize()
    assert eng.ACCUMULATE_LAUNCHES.launches == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)
    # the traversal's group-major carry: the same scores
    gmajor = carry.t().contiguous().t()
    assert torch.equal(eng.accumulate_forest(gmajor, gof, leaf, tc,
                                             num_class, freq, es[1]), ref)


@pytest.mark.cuda
def test_accumulate_kernel_refuses_maps_out_of_range(cuda_device):
    carry, gof, leaf, tc = _accumulate_case(3, 97, cuda_device)
    before = eng.ACCUMULATE_LAUNCHES.launches
    bad_g, bad_c = gof.clone(), tc.clone()
    bad_g[-1] = carry.shape[1]
    bad_c[0] = 3
    with pytest.raises(ValueError, match="group_of_tree"):
        eng.accumulate_forest(carry, bad_g, leaf, tc, 3, 0, 0.0)
    with pytest.raises(ValueError, match="tree_class"):
        eng.accumulate_forest(carry, gof, leaf, bad_c, 3, 0, 0.0)
    assert eng.ACCUMULATE_LAUNCHES.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_compiled_dispatch_is_one_launch_of_each_kernel(kind, cuda_device):
    """A compiled dispatch on the card is one launch of the fused kernel,
    and neither K3 alone nor the accumulation alone."""
    text, _trees, feats = _forest(kind)
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    art = compile_forest(gb)
    cf = eng.CompiledForest(art, cuda_device)
    X = _rows(kind, 601, feats, seed=3)
    want = eng.CompiledForest(art, torch.device("cpu")).predict(
        torch.from_numpy(X))
    eng.PREDICT_LAUNCHES.reset()
    eng.TRAVERSE_LAUNCHES.reset()
    eng.ACCUMULATE_LAUNCHES.reset()
    got = cf.predict(torch.from_numpy(X).to(cuda_device))
    torch.cuda.synchronize()
    assert eng.PREDICT_LAUNCHES.launches == 1
    assert eng.TRAVERSE_LAUNCHES.launches == 0
    assert eng.ACCUMULATE_LAUNCHES.launches == 0
    assert torch.equal(got.cpu(), want)


def _fused_case(kind, dev, early_stop):
    """(CompiledForest on ``dev``, early-stop freq, margin): early stop
    checks every round at half the median final margin of 4,096 rows."""
    text, _trees, feats = _forest(kind)
    art = compile_forest(lgt.Booster(model_str=text, params=CPU)._booster)
    cf = eng.CompiledForest(art, dev)
    if not early_stop:
        return cf, 0, 0.0, feats
    full = cf.predict(torch.from_numpy(_rows(kind, 4096, feats)).to(dev))
    K = cf.num_class
    if K == 1:
        final = 2 * full[0].abs()
    else:
        top2 = full.topk(2, dim=0).values
        final = top2[0] - top2[1]
    freq, margin = K, 0.5 * float(final.median())
    return (eng.CompiledForest(art, dev, early_stop_freq=freq,
                               early_stop_margin=margin), freq, margin,
            feats)


def _plain(cf, x):
    t = cf.tables
    return eng._predict_forest_reference(
        x, t, t.group_tree_lo, t.group_tree, cf._leaf_value, cf._tree_class,
        cf.num_class, cf.early_stop_freq, cf._es_margin, linear=cf.linear)


@functools.lru_cache(maxsize=None)
def _linear_text(kind):
    """The ``kind`` forest's structures with linear leaves
    (``synth.linearize``: path features, random coefficients)."""
    text, trees, feats = _forest(kind)
    trees = synth.linearize([copy.deepcopy(t) for t in trees], 11)
    return booster_from_numpy(synth.header(feats), trees,
                              CPU).model_to_string(), feats


def _member(kind, dev):
    """(CompiledForest, features) of ``kind`` ("<kind>@linear": its linear
    version)."""
    base, _, linear = kind.partition("@")
    if linear:
        text, feats = _linear_text(base)
    else:
        text, _trees, feats = _forest(base)
    art = compile_forest(lgt.Booster(model_str=text, params=CPU)._booster)
    return eng.CompiledForest(art, dev), feats


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "categorical", "large", "mslr"])
@pytest.mark.parametrize("rows", [1, 97, 256, 601, 4096])
def test_linear_kernel_equals_plain_version_on_card(kind, rows,
                                                    cuda_device):
    """The linear mode: one launch equal to its plain version on rows with
    NaN cells and all-NaN rows (the fallback to leaf_value), the rows
    staged in shared memory or read from global memory (136 features);
    reruns and a row alone bit-identical; not the constant mode's
    answer."""
    cf, feats = _member(kind + "@linear", cuda_device)
    assert cf.linear is not None and cf.linear.leaf_feat.shape[2] >= 1
    x = torch.from_numpy(_rows(kind, rows, feats, seed=2)).to(cuda_device)
    ref = _plain(cf, x)
    eng.PREDICT_LAUNCHES.reset()
    got = cf.predict(x)
    again = cf.predict(x)
    assert _counters_zero(cuda_device)
    assert eng.PREDICT_LAUNCHES.launches == 2
    assert got.shape == ref.shape and torch.equal(got, ref)
    assert torch.equal(again, got)
    assert torch.equal(cf.predict(x[:1]), got[:, :1])
    t = cf.tables
    assert torch.equal(eng.predict_forest(
        x, t, t.group_tree_lo, t.group_tree, cf._leaf_value, cf._tree_class,
        cf.num_class, 0, 0.0, linear=cf.linear), ref)
    cf_const, _ = _member(kind, cuda_device)
    if rows >= 97:
        assert not torch.equal(got, cf_const.predict(x))


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [
    ("numeric@linear", "categorical", "multiclass"),
    ("merged", "mslr@linear", "categorical@linear")])
@pytest.mark.parametrize("rows", [1, 97, 601, 4096])
def test_linear_packed_kernel_equals_plain_version_and_members_on_card(
        kinds, rows, cuda_device):
    """The packed mode with linear and constant members: one launch equal
    to its plain version and, row by row, to each member's own launch."""
    cfs = {kind: _member(kind, cuda_device)[0] for kind in kinds}
    packed = eng.PackedForests(cfs)
    assert packed.linear is not None
    rng = np.random.RandomState(rows)
    rm = rng.randint(0, len(cfs), rows).astype(np.int32)
    x = np.full((rows, packed.width), np.nan, np.float32)
    for i, kind in enumerate(cfs):
        base = kind.partition("@")[0]
        feats = _forest(base)[2]
        mine = rm == i
        x[mine, :feats] = _rows(base, int(mine.sum()), feats, rows)
    xt = torch.from_numpy(x).to(cuda_device)
    rmt = torch.from_numpy(rm).to(cuda_device)
    t = packed.tables
    ref = eng._predict_forest_reference(
        xt, t, t.group_tree_lo, t.group_tree, packed._leaf_value,
        packed._tree_class, packed.num_class, 0, 0.0, rmt,
        packed._group_model, packed.linear)
    eng.PREDICT_LAUNCHES.reset()
    got = packed.predict(xt, rm)
    again = packed.predict(xt, rm)
    assert _counters_zero(cuda_device)
    assert eng.PREDICT_LAUNCHES.launches == 2
    assert got.shape == ref.shape and torch.equal(got, ref)
    assert torch.equal(again, got)
    for i, cf in enumerate(cfs.values()):
        mine = torch.from_numpy(np.nonzero(rm == i)[0]).to(cuda_device)
        if mine.numel():
            solo = cf.predict(xt[mine, :cf.width].contiguous())
            assert torch.equal(got[:cf.num_class, mine], solo)
            assert not got[cf.num_class:, mine].any()


def _counters_zero(dev):
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return int(eng._counters[(dev.index, stream)].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["merged", "categorical", "large",
                                  "multiclass", "multiclass20"])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("rows", [1, 97, 256, 257, 601, 4096])
def test_fused_kernel_equals_plain_version_on_card(kind, early_stop, rows,
                                                   cuda_device):
    cf, freq, margin, feats = _fused_case(kind, cuda_device, early_stop)
    x = torch.from_numpy(_rows(kind, rows, feats, seed=1)).to(cuda_device)
    ref = _plain(cf, x)
    eng.PREDICT_LAUNCHES.reset()
    got = cf.predict(x)
    again = cf.predict(x)
    assert _counters_zero(cuda_device)
    assert eng.PREDICT_LAUNCHES.launches == 2
    assert got.shape == ref.shape and torch.equal(got, ref)
    assert torch.equal(again, got)                     # reruns bit-identical
    assert torch.equal(cf.predict(x[:1]), got[:, :1])  # a row alone
    if early_stop and rows == 4096:                    # the replay stops rows
        assert not torch.equal(got, _plain(_fused_case(
            kind, cuda_device, False)[0], x))
    # the public wrapper checks the maps, then launches the same kernel
    t = cf.tables
    assert torch.equal(eng.predict_forest(
        x, t, t.group_tree_lo, t.group_tree, cf._leaf_value, cf._tree_class,
        cf.num_class, freq, margin), ref)


def _pack_case(kinds, dev):
    """(PackedForests of the ``kinds`` forests on ``dev``, their
    CompiledForests by kind)."""
    cfs = {}
    for kind in kinds:
        text, _trees, _feats = _forest(kind)
        art = compile_forest(lgt.Booster(model_str=text, params=CPU)._booster)
        cfs[kind] = eng.CompiledForest(art, dev)
    return eng.PackedForests(cfs), cfs


def _pack_rows(packed, cfs, n, seed):
    """(rows [n, pack width], member of each row): each row its member's
    kind of rows, NaN past the member's features."""
    rng = np.random.RandomState(seed)
    rm = rng.randint(0, len(cfs), n).astype(np.int32)
    x = np.full((n, packed.width), np.nan, np.float32)
    for i, kind in enumerate(cfs):
        feats = _forest(kind)[2]
        mine = rm == i
        x[mine, :feats] = _rows(kind, int(mine.sum()), feats, seed)
    return x, rm


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [("numeric", "categorical", "multiclass"),
                                   ("merged", "mslr", "categorical")])
@pytest.mark.parametrize("rows", [1, 97, 256, 601, 4096])
def test_packed_kernel_equals_plain_version_and_members_on_card(
        kinds, rows, cuda_device):
    """The fused kernel's packed mode: one launch equal to its plain
    version and, row by row, to each member's own launch; reruns
    bit-identical; 8-group blocks and 256-row tiles straddle members; the
    136-column pack reads its rows from global memory (no staging)."""
    packed, cfs = _pack_case(kinds, cuda_device)
    gm = packed._group_model.tolist()
    assert any(len(set(gm[i:i + 8])) > 1 for i in range(0, len(gm), 8))
    x, rm = _pack_rows(packed, cfs, rows, seed=rows)
    xt = torch.from_numpy(x).to(cuda_device)
    rmt = torch.from_numpy(rm).to(cuda_device)
    t = packed.tables
    ref = eng._predict_forest_reference(
        xt, t, t.group_tree_lo, t.group_tree, packed._leaf_value,
        packed._tree_class, packed.num_class, 0, 0.0, rmt,
        packed._group_model)
    eng.PREDICT_LAUNCHES.reset()
    got = packed.predict(xt, rm)
    again = packed.predict(xt, rm)
    assert _counters_zero(cuda_device)
    assert eng.PREDICT_LAUNCHES.launches == 2
    assert got.shape == ref.shape and torch.equal(got, ref)
    assert torch.equal(again, got)
    assert torch.equal(eng.predict_forest(
        xt, t, t.group_tree_lo, t.group_tree, packed._leaf_value,
        packed._tree_class, packed.num_class, 0, 0.0, rmt,
        packed._group_model), got)
    for i, cf in enumerate(cfs.values()):
        mine = torch.from_numpy(np.nonzero(rm == i)[0]).to(cuda_device)
        if mine.numel():
            solo = cf.predict(xt[mine, :cf.width].contiguous())
            assert torch.equal(got[:cf.num_class, mine], solo)
            assert not got[cf.num_class:, mine].any()


@pytest.mark.cuda
def test_null_row_model_leaves_the_unpacked_launch_unchanged(cuda_device):
    """Null packed maps are today's launch (== its plain version); a
    one-member pack gives the same bits."""
    cf, _, _, feats = _fused_case("merged", cuda_device, False)
    x = torch.from_numpy(_rows("merged", 601, feats, seed=4)).to(cuda_device)
    base = cf.predict(x)
    assert torch.equal(base, _plain(cf, x))
    packed = eng.PackedForests({"m": cf})
    assert torch.equal(packed.predict(x, np.zeros(601, np.int32)), base)


@pytest.mark.cuda
def test_fused_counters_zero_after_back_to_back_dispatches(cuda_device):
    """Three dispatches of different row counts queued without a
    synchronize in between: each equals the plain version, and every
    counter is back at zero."""
    cf, _, _, feats = _fused_case("merged", cuda_device, False)
    xs = [torch.from_numpy(_rows("merged", n, feats, seed=n)).to(cuda_device)
          for n in (4096, 1, 601)]
    outs = [cf.predict(x) for x in xs]
    assert _counters_zero(cuda_device)
    for x, out in zip(xs, outs):
        assert torch.equal(out, _plain(cf, x))


@pytest.mark.cuda
def test_fused_kernel_on_two_streams_at_once(cuda_device):
    """Two dispatches that may overlap on two streams each get their own
    counters and the plain version's scores."""
    cf, _, _, feats = _fused_case("multiclass", cuda_device, False)
    xs = [torch.from_numpy(_rows("multiclass", n, feats, seed=n)).to(
        cuda_device) for n in (4096, 3000)]
    streams = [torch.cuda.Stream(cuda_device) for _ in xs]
    outs = []
    for x, s in zip(xs, streams):
        s.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(s):
            outs.append(cf.predict(x))
    torch.cuda.synchronize()
    bufs = [eng._counters[(cuda_device.index, s.cuda_stream)]
            for s in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert all(int(b.abs().sum()) == 0 for b in bufs)
    for x, out in zip(xs, outs):
        assert torch.equal(out, _plain(cf, x))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_compiled_engine_and_server_equal_scan_on_card(kind, cuda_device):
    text, _trees, feats = _forest(kind)
    X = _rows(kind, 700, feats, seed=2)
    bst = lgt.Booster(model_str=text)
    assert bst._booster.device.type == "cuda"
    got = bst.predict(X, raw_score=True)
    ref = lgt.Booster(model_str=text, params={"predict_engine": "scan"}
                      ).predict(X, raw_score=True)
    assert np.array_equal(got, ref)
    with bst.as_server(raw_score=True) as server:
        assert np.array_equal(server.predict(X), ref)


def _hist_case(shape, dev):
    """chip_smoke's K1 shapes (T2): the HIGGS root, a leaf behind a
    permutation slice with out-of-range ids past count, u16 bins with a
    ragged count, count 0; a skewed root (90% of the rows in bin 0 of
    every feature); extreme gradients (1e-30 to 1e3, both signs) at a
    leaf one row past three blocks' row budget."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = {"root": 10_500_000, "leaf": 10_500_000, "empty": 10_500_000,
         "skewed": 2_000_003, "extreme": 1_000_003}.get(shape, 100_003)
    f, nb = (8, 1024) if shape == "u16" else (28, 256)
    bins = torch.randint(0, nb - 1, (n, f), generator=gen, device=dev,
                         dtype=torch.int32)
    if shape == "skewed":
        bins[torch.rand(n, generator=gen, device=dev) < 0.9] = 0
    bins = bins.to(torch.uint8 if nb <= 256 else torch.uint16)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev)
    if shape == "extreme":
        sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1
        grad = 10.0 ** (torch.rand(n, generator=gen, device=dev) * 33 - 30) \
            * sign
        hess = 10.0 ** (torch.rand(n, generator=gen, device=dev) * 33 - 30)
        rows = torch.randperm(n, generator=gen, device=dev).int()
        count = torch.tensor([3 * _block_rows() + 1], dtype=torch.int32,
                             device=dev)
        return bins, grad, hess, rows, count, nb
    if shape in ("root", "skewed"):
        return bins, grad, hess, None, n, nb
    if shape == "u16":
        rows = torch.randperm(n, generator=gen, device=dev)[:90_000].int()
        return bins, grad, hess, rows, 77_777, nb
    leaf = n // 255
    rows = torch.randperm(n, generator=gen, device=dev)[:2 * leaf].int()
    rows[leaf:] = 2 ** 31 - 1
    count = torch.tensor([0 if shape == "empty" else leaf],
                         dtype=torch.int32, device=dev)
    return bins, grad, hess, rows, count, nb


def _block_rows():
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    return hc._MIN_BLOCK_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["root", "leaf", "u16", "empty", "skewed",
                                   "extreme"])
def test_hist_kernel_equals_plain_version_on_card(shape, cuda_device):
    """K1 against its plain version: both sum the same fixed-point
    integers, so every channel is ``torch.equal``; a rerun bit-identical,
    one launch counted."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    args = _hist_case(shape, cuda_device)
    before = hc.HIST_LAUNCHES.launches
    got = hc.hist_rows(*args)
    again = hc.hist_rows(*args)
    ref = hc._hist_reference(*args)
    torch.cuda.synchronize()
    assert hc.HIST_LAUNCHES.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, ref)
    if shape == "empty":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["root", "leaf"])
def test_hist_kernel_at_mslr_width_equals_plain_version(shape, cuda_device):
    """K1 at MSLR-WEB30K's width, 136 u8 features and 255 bins, where the
    grid splits the features into several tiles: the root of 2,270,296
    rows and a leaf of N/255 rows behind a permutation slice with junk past
    its count, gradients spread over four decades like a ranker's lambdas;
    every channel ``torch.equal``, a rerun bit-identical."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(6)
    n, f, nb = 2_270_296, 136, 256
    bins = torch.randint(0, 255, (n, f), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    grad = torch.randn(n, generator=gen, device=dev) * 10.0 ** (
        torch.rand(n, generator=gen, device=dev) * 4 - 3)
    hess = torch.rand(n, generator=gen, device=dev) * 0.1
    if shape == "root":
        args = (bins, grad, hess, None, n, nb)
        P = n
    else:
        leaf = n // 255
        rows = torch.randperm(n, generator=gen, device=dev)[:2 * leaf].int()
        rows[leaf:] = 2 ** 31 - 1
        args = (bins, grad, hess, rows, torch.tensor(
            [leaf], dtype=torch.int32, device=dev), nb)
        P = 2 * leaf
    _, f_tile = hc._grid(hc.HIST_SOURCE, hc._kernel_lib(hc.HIST_SOURCE, dev),
                         dev, bins, P, nb)
    assert f_tile < f
    got = hc.hist_rows(*args)
    again = hc.hist_rows(*args)
    ref = hc._hist_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, ref)
    live = n if shape == "root" else n // 255
    assert int(got[..., 2].double().sum()) == live * f


@pytest.mark.cuda
def test_hist_kernel_refuses_bad_inputs(cuda_device):
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    bins, grad, hess, _, n, nb = _hist_case("u16", cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        hc.hist_rows(bins[:, ::2], grad, hess, None, n, nb)
    with pytest.raises(TypeError, match="f32"):
        hc.hist_rows(bins, grad.double(), hess, None, n, nb)
    with pytest.raises(ValueError, match="is on"):
        hc.hist_rows(bins, grad.cpu(), hess, None, n, nb)


@pytest.mark.cuda
def test_training_on_card_equals_cpu(cuda_device):
    """A short training on the card (K1 histograms) against the same on
    the CPU (plain histograms): predictions on the training rows within
    rtol 1e-4 / atol 1e-5 (the histograms are equal; the split scans and
    objectives on the two devices may still differ in a last bit)."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(0)
    X = rng.randn(6000, 12)
    X[::7, 3] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(6000) > 0
         ).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    before = hc.HIST_LAUNCHES.launches
    card = lgt.train(params, lgt.Dataset(X, label=y), 10)
    assert card._booster.learner.x_rows.device.type == "cuda"
    assert hc.HIST_LAUNCHES.launches > before
    cpu = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 10)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_serial_learner_on_card_equals_cpu(cuda_device):
    """The host-driven SerialTreeLearner (``tpu_fused_learner=0``) with
    lazy CEGB, bagging and advanced monotone constraints on the card (K1
    histograms, one launch a histogram built) against the same on the
    CPU: the same trees and predictions within rtol 1e-4 / atol 1e-5; and
    the lazy penalty's unpaid-row counts of a leaf slice on the card equal
    a numpy count over the paid-row mask."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(4)
    X = rng.randint(0, 8, (6000, 8)).astype(np.float64)
    y = X[:, 0] - 0.5 * X[:, 1] + np.sin(X[:, 2]) + 0.3 * rng.randn(6000)
    params = {"objective": "regression", "num_leaves": 31, "verbose": -1,
              "tpu_fused_learner": "0", "bagging_fraction": 0.8,
              "bagging_freq": 1, "cegb_penalty_split": 0.001,
              "cegb_penalty_feature_lazy": [0.01, 0.02, 0.05, 0, 0.01,
                                            0.03, 0.02, 0.01],
              "monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
              "monotone_constraints_method": "advanced"}
    built = []      # each tree's histograms (one tree a round)

    def count_builds(env):
        built.append(env.model._booster.learner.hist_builds)

    before = hc.HIST_LAUNCHES.launches
    card = lgt.train(params, lgt.Dataset(X, label=y), 3,
                     callbacks=[count_builds])
    lr = card._booster.learner
    assert lr.x_rows.device.type == "cuda"
    assert len(built) == 3 and min(built) > 0
    assert hc.HIST_LAUNCHES.launches - before == sum(built)
    cpu = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 3)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(card._booster.host_models, cpu._booster.host_models):
        assert a.split_feature == b.split_feature
    b, c = int(lr.last_leaf_begin[1]), int(lr.last_leaf_count[1])
    rows = lr.last_perm[b:b + c]
    mask = torch.from_numpy(rng.rand(6000) < 0.8).to(cuda_device)
    split = torch.tensor(c // 3, device=cuda_device)
    got = lr._lazy_unpaid(rows, mask, split).cpu().numpy()
    paid = lr._paid.cpu().numpy()
    r = rows.cpu().numpy().astype(np.int64)
    unpaid = ~paid[:, r] & mask.cpu().numpy()[r]
    want = np.stack([unpaid[:, :c // 3].sum(1), unpaid[:, c // 3:].sum(1)])
    np.testing.assert_array_equal(got, want)
    assert paid.any() and want.sum() > 0


@pytest.mark.cuda
def test_masked_hist_kernel_equals_plain_version_on_card(cuda_device):
    """K1 with a bagging mask: out-of-bag rows add to no channel; every
    channel ``torch.equal`` to the plain version."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    bins, grad, hess, rows, count, nb = _hist_case("leaf", cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    mask = torch.rand(bins.shape[0], generator=gen, device=cuda_device) < 0.8
    for args in ((bins, grad, hess, None, 1_000_003, nb, mask),
                 (bins, grad, hess, rows, count, nb, mask)):
        got = hc.hist_rows(*args)
        ref = hc._hist_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, hc.hist_rows(*args))
        assert torch.equal(got, ref)


def _hist_q_case(shape, dev):
    """chip_smoke's K2 shapes (T2q) with int8 levels and a mask; the
    saturated one puts every row of the root in bin 0 with g_q = -127 and
    h_q = 127, so a packed field that overflowed would show."""
    bins, _, _, rows, count, nb = _hist_case(
        "root" if shape == "saturated" else shape, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    n = bins.shape[0]
    gq = torch.randint(-63, 64, (n,), generator=gen, device=dev,
                       dtype=torch.int8)
    hq = torch.randint(0, 127, (n,), generator=gen, device=dev,
                       dtype=torch.int8)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    if shape == "saturated":
        bins.zero_()
        gq.fill_(-127)
        hq.fill_(127)
    return bins, gq, hq, rows, count, nb, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["root", "leaf", "u16", "empty",
                                   "saturated", "skewed"])
def test_hist_q_kernel_equals_plain_version_on_card(shape, cuda_device):
    """K2 against its plain version: integer sums, so ``torch.equal``; a
    rerun bit-identical; one launch counted per call."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    args = _hist_q_case(shape, cuda_device)
    before = hc.HIST_Q_LAUNCHES.launches
    got = hc.hist_rows_q(*args)
    again = hc.hist_rows_q(*args)
    ref = hc._hist_q_reference(*args)
    torch.cuda.synchronize()
    assert hc.HIST_Q_LAUNCHES.launches == before + 2
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
    if shape == "empty":
        assert not got.any()
    # without a mask every live position counts once per feature
    nomask = hc.hist_rows_q(*args[:6])
    assert torch.equal(nomask, hc._hist_q_reference(*args[:6]))


@pytest.mark.cuda
def test_hist_kernels_read_a_leaf_through_an_offset(cuda_device):
    """Both kernels read position p at rows[offset + p] of the parent's
    slice, with junk outside the child's range, exactly as they read the
    child's own slice."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    bins, grad, hess, _, _, nb = _hist_case("root", cuda_device)
    _, gq, hq, _, _, _, mask = _hist_q_case("root", cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    parent = torch.randperm(bins.shape[0], generator=gen,
                            device=cuda_device)[:82_353].int()
    for off, count in ((0, 41_176), (41_176, 41_177), (5, 2_048)):
        junk = parent.clone()
        junk[:off] = 2 ** 31 - 1
        junk[off + count:] = -7
        o = torch.tensor([off], dtype=torch.int32, device=cuda_device)
        c = torch.tensor([count], dtype=torch.int32, device=cuda_device)
        child = parent[off:off + count].contiguous()
        assert torch.equal(hc.hist_rows(bins, grad, hess, junk, c, nb, mask,
                                        o),
                           hc.hist_rows(bins, grad, hess, child, count, nb,
                                        mask))
        assert torch.equal(hc.hist_rows_q(bins, gq, hq, junk, c, nb, mask,
                                          o),
                           hc.hist_rows_q(bins, gq, hq, child, count, nb,
                                          mask))
    torch.cuda.synchronize()


def _sorted_copy(t, perm):
    """t's rows in the order of perm on the card (u16 moves as int16:
    torch's CUDA indexing has no uint16)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[perm].view(torch.uint16)
    return t[perm].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["root", "leaf", "leaf_masked", "u16",
                                  "empty"])
def test_hist_kernels_read_a_sorted_window_on_card(case, cuda_device):
    """K1 and K2 with no row list (tree_layout=sorted): position p reads row
    offset + p of the leaf-ordered bins, channels and mask, the next leaf's
    rows past the count never count. Each is ``torch.equal`` to its plain
    version (one launch and one window launch counted a call), and K1 / K2
    on the sorted window equal K1 / K2 gathered through ``perm`` on the
    same leaf: the root, a 41,176-row leaf (T3's N/255) at a non-zero
    offset inside its parent's window, the same with a bagging mask, u16
    bins with a ragged count, and an empty leaf."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    dev = cuda_device
    shape = "u16" if case == "u16" else "root"
    bins, grad, hess, _, _, nb = _hist_case(shape, dev)
    _, gq, hq, _, _, _, mask = _hist_q_case(shape, dev)
    if case in ("root", "leaf"):
        mask = None
    n = bins.shape[0]
    gen = torch.Generator(device=dev).manual_seed(10)
    perm = torch.randperm(n, generator=gen, device=dev).int()
    p = perm.long()
    xs, gs, hs, gqs, hqs = (_sorted_copy(t, p) for t in (bins, grad, hess,
                                                          gq, hq))
    ms = None if mask is None else mask[p].contiguous()
    scale = hc.hist_scale(grad, hess)     # the dataset order's, as trained
    if case == "root":
        begin, parent, off, live = 0, n, 0, n
    elif case == "u16":
        begin, parent, off, live = 1_001, 90_000, 12_000, 77_777
    else:       # the right child of a split, the next leaf's rows past it
        begin, parent, off, live = 1_003, 82_355, 41_179, 41_176
        live = 0 if case == "empty" else live
    o = torch.tensor([off], dtype=torch.int32, device=dev)
    c = torch.tensor([live], dtype=torch.int32, device=dev)
    w = slice(begin, begin + parent)
    mw = None if ms is None else ms[w]
    rows = perm[w]
    args = (xs[w], gs[w], hs[w], None, c, nb, mw, o, scale)
    qargs = (xs[w], gqs[w], hqs[w], None, c, nb, mw, o)
    before = (hc.HIST_LAUNCHES.launches, hc.HIST_WINDOW_LAUNCHES.launches,
              hc.HIST_Q_LAUNCHES.launches, hc.HIST_Q_WINDOW_LAUNCHES.launches)
    got, got_q = hc.hist_rows(*args), hc.hist_rows_q(*qargs)
    after = (hc.HIST_LAUNCHES.launches, hc.HIST_WINDOW_LAUNCHES.launches,
             hc.HIST_Q_LAUNCHES.launches, hc.HIST_Q_WINDOW_LAUNCHES.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 1]
    assert torch.equal(got, hc._hist_reference(*args))
    assert torch.equal(got_q, hc._hist_q_reference(*qargs))
    assert torch.equal(got, hc.hist_rows(bins, grad, hess, rows, c, nb, mask,
                                         o, scale))
    assert torch.equal(got_q, hc.hist_rows_q(bins, gq, hq, rows, c, nb, mask,
                                             o))
    assert torch.equal(got, hc.hist_rows(*args))
    torch.cuda.synchronize()
    live_rows = p[begin + off:begin + off + live]
    inbag = live if mask is None else int(mask[live_rows].sum())
    assert int(got_q[..., 2].long().sum()) == inbag * bins.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {},
    {"use_quantized_grad": True, "num_grad_quant_bins": 4,
     "bagging_fraction": 0.7, "bagging_freq": 1},
    {"tpu_fused_learner": "0", "bagging_fraction": 0.7, "bagging_freq": 1},
])
def test_sorted_layout_on_card_equals_gather(extra, cuda_device):
    """tree_layout=sorted on the card grows gather's model, byte for byte
    but for the layout's parameter line; every histogram of the sorted run
    is a window launch of its kernel (K2 when quantized)."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(12)
    X = rng.randn(6000, 10)
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(6000)
    params = {"objective": "regression", "num_leaves": 31, "verbose": -1,
              **extra}
    quant = "use_quantized_grad" in extra
    texts, built = {}, []
    for layout in ("gather", "sorted"):
        built.clear()
        before = (hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches,
                  hc.HIST_WINDOW_LAUNCHES.launches,
                  hc.HIST_Q_WINDOW_LAUNCHES.launches)
        bst = lgt.train({**params, "tree_layout": layout},
                        lgt.Dataset(X, label=y), 4,
                        callbacks=[lambda env: built.append(
                            env.model._booster.learner.hist_builds)])
        after = (hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches,
                 hc.HIST_WINDOW_LAUNCHES.launches,
                 hc.HIST_Q_WINDOW_LAUNCHES.launches)
        k1, k2, w1, w2 = (b - a for a, b in zip(before, after))
        assert bst._booster.learner.layout == layout
        assert (k2 if quant else k1) == sum(built) > 0
        assert (k1 if quant else k2) == 0
        if layout == "sorted":
            assert (w2 if quant else w1) == sum(built)
        texts[layout] = "\n".join(
            ln for ln in bst.model_to_string().splitlines()
            if not ln.startswith("[tree_layout:"))
    assert texts["sorted"] == texts["gather"]


@pytest.mark.cuda
def test_hist_kernels_from_two_threads_on_one_stream(cuda_device):
    """Two host threads build histograms at once on the same (default)
    stream: K1's two launches share one accumulator per stream, so one
    thread's sums must never land in the other's histogram. Every result
    is ``torch.equal`` to its plain version."""
    import threading
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    cases = [_hist_case("root", cuda_device), _hist_case("leaf", cuda_device)]
    want = [hc._hist_reference(*a) for a in cases]
    qcase = _hist_q_case("leaf", cuda_device)
    qwant = hc._hist_q_reference(*qcase)
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    bad, errors = [], []

    def work(i):
        try:
            start.wait()
            for _ in range(25):
                got = hc.hist_rows(*cases[i])
                q = hc.hist_rows_q(*qcase)
                torch.cuda.synchronize()
                if not torch.equal(got, want[i]) or not torch.equal(q, qwant):
                    bad.append(i)
        except Exception as e:      # surfaced below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert not bad, f"{len(bad)} histograms differ from the plain version"


@pytest.mark.cuda
def test_threefry_and_quantization_on_card_equal_cpu(cuda_device):
    """The threefry draw and the quantized levels on the card equal the
    CPU's bit for bit."""
    from lambdagap_tpu_torch.ops.hist_cuda import quantize_gradients
    from lambdagap_tpu_torch.utils import prng
    key = prng.split(prng.PRNGKey(7919 + 1))[1]
    for n in (1, 7, 1000, 1_000_003):
        assert torch.equal(prng.uniform(key, n, cuda_device).cpu(),
                           prng.uniform(key, n))
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randn(100_001).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(100_001)).astype(np.float32))
    for qb, stochastic in ((4, True), (16, False), (127, True)):
        cpu = quantize_gradients(g, h, key, qb, stochastic)
        card = quantize_gradients(g.to(cuda_device), h.to(cuda_device), key,
                                  qb, stochastic)
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"use_quantized_grad": True, "num_grad_quant_bins": 16,
     "quant_train_renew_leaf": True, "bagging_fraction": 0.7,
     "bagging_freq": 1},
    {"data_sample_strategy": "goss", "learning_rate": 0.3},
    {"_efb": True},
])
def test_sampled_quantized_bundled_training_on_card_equals_cpu(extra,
                                                               cuda_device):
    """Short trainings on the card (K2 or K1 with a mask, over EFB
    bundles) against the same on the CPU, at the training-row bar."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    extra = dict(extra)
    efb = extra.pop("_efb", False)
    rng = np.random.RandomState(1)
    X = rng.randn(6000, 8)
    if efb:
        which = rng.randint(0, 7, 6000)
        sparse = np.zeros((6000, 6))
        on = which < 6
        sparse[np.nonzero(on)[0], which[on]] = rng.randint(1, 9, on.sum())
        X = np.concatenate([X, sparse], axis=1)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(6000) > 0
         ).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              **extra}
    counter = (hc.HIST_Q_LAUNCHES if extra.get("use_quantized_grad")
               else hc.HIST_LAUNCHES)
    before = counter.launches
    card = lgt.train(params, lgt.Dataset(X, label=y), 10)
    assert counter.launches > before
    if efb:
        lr = card._booster.learner
        assert lr.bundle is not None and lr.x_rows.shape[1] < X.shape[1]
    cpu = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 10)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=1e-4,
                               atol=1e-5)


def _ltr(n_queries=120, seed=0):
    """Queries of 1 to 60 documents, graded labels 0-4 from a latent."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 61, n_queries)
    n = int(sizes.sum())
    X = rng.randn(n, 10)
    latent = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    y = np.clip(np.floor(latent + 1.0), 0, 4)
    pos = np.concatenate([np.arange(k) for k in sizes])
    return X, y, sizes, pos


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"lambdarank_target": "ndcg"},
    {"lambdarank_target": "lambdagap-x-plus-plus", "lambdagap_weight": 0.5},
    {"objective": "rank_xendcg"},
    {"_position": True, "bagging_fraction": 0.7, "bagging_freq": 1,
     "bagging_by_query": True},
])
def test_ranking_on_card_equals_cpu(extra, cuda_device):
    """Rankers trained on the card (the lambda pass in torch ops on the
    card, K1 histograms) against the same on the CPU, at the training-row
    bar."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    extra = dict(extra)
    X, y, sizes, pos = _ltr()
    position = pos if extra.pop("_position", False) else None
    params = {"objective": "lambdarank", "num_leaves": 31,
              "min_data_in_leaf": 10, "verbose": -1, **extra}
    before = hc.HIST_LAUNCHES.launches
    card = lgt.train(params, lgt.Dataset(X, label=y, group=sizes,
                                         position=position), 10)
    assert hc.HIST_LAUNCHES.launches > before
    assert card._booster.scores.device.type == "cuda"
    cpu = lgt.train({**params, **CPU}, lgt.Dataset(
        X, label=y, group=sizes, position=position), 10)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_seven_class_early_stop_serving_on_card_equals_scan(cuda_device):
    """A 7-class forest's compiled dispatch on the card with early stop
    (the accumulation kernel's top-2 margin over seven scores) equals the
    scan oracle on the card."""
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    trees = synth.random_trees(5, 70, 31, 10, grid_size=40)
    text = booster_from_numpy(synth.header(10, "multiclass num_class:7"),
                              trees, CPU).model_to_string()
    X = synth.random_rows(np.random.RandomState(3), 4096, 10)
    forest, depth = forest_to_arrays(
        lgt.Booster(model_str=text, params=CPU)._booster.models,
        device=cuda_device)
    x = torch.from_numpy(X).to(cuda_device)
    tc = [i % 7 for i in range(len(trees))]
    full = predict_forest(x, forest, tc, 7, depth).T.cpu().numpy()
    top2 = np.sort(full, axis=1)[:, -2:]
    margin = float(np.median(top2[:, 1] - top2[:, 0]))   # stops about half
    bst = lgt.Booster(model_str=text, params={
        "pred_early_stop": True, "pred_early_stop_freq": 2,
        "pred_early_stop_margin": margin})
    got = bst.predict(X, raw_score=True)
    want = predict_forest(x, forest, tc, 7, depth, early_stop_freq=14,
                          early_stop_margin=margin).T.cpu().numpy()
    assert got.shape == (4096, 7) and np.array_equal(got, want)
    assert (want != full).any()


def _deep_tree(seed=0, features=255, leaves=16384):
    """A 16,384-leaf tree whose leftmost path splits 250 distinct features
    in a row (then random splits): its longest merged path has 251-256
    elements, at the top of kernel S's cap. Every other leaf is zeroed:
    the unwound sums of long paths are ill-conditioned (the recurrence's
    subtractions amplify rounding by up to C(e, k) z^k, and this
    synthetic tree's internal edges have zero fraction 1), so summing
    many such paths in two orders parts far beyond rounding, while the
    one path left runs the same operations in the same order in the
    kernel and its plain version."""
    from lambdagap_tpu_torch.models import shap
    from lambdagap_tpu_torch.models.tree import Tree
    rng = np.random.RandomState(seed)
    tree = Tree(max_leaves=leaves)
    for f in range(250):
        tree.split(0, f, f, 0, float(rng.randn()), bool(f % 2), f % 3, 1.0,
                   float(rng.normal(0, 0.02)), float(rng.normal(0, 0.02)),
                   1.0, 1.0, 1, 1)
    while tree.num_leaves < leaves:
        f = int(rng.randint(features))
        tree.split(int(rng.randint(tree.num_leaves)), f, f, 0,
                   float(rng.randn()), bool(rng.rand() < 0.5),
                   int(rng.randint(3)), 1.0, float(rng.normal(0, 0.02)),
                   float(rng.normal(0, 0.02)), 1.0, 1.0, 1, 1)
    longest = np.diff(shap.build_paths([tree], [0], 1).path_elem_lo).argmax()
    tree.leaf_value[:leaves][np.arange(leaves) != longest] = 0.0
    tree.leaf_value[longest] = 0.05
    return tree


def _shap_case(kind):
    """(trees, tree classes, classes, rows) for kernel S. "mixed": the
    deep tree and ten ordinary 31-leaf trees, so that one call runs both
    the grouped and the long-path kernels; "mslr": 255-leaf trees over
    MSLR-WEB30K's 136 features; "wide": 4,000 features, too many for the
    per-warp partials in shared memory."""
    rng = np.random.RandomState(4)
    if kind == "deep":
        return [_deep_tree()], [0], 1, synth.random_rows(rng, 16, 255)
    if kind == "mixed":
        trees = [_deep_tree()] + synth.random_trees(9, 10, 31, 255,
                                                    grid_size=40)
        return trees, [0] * 11, 1, synth.random_rows(rng, 16, 255)
    if kind == "multiclass":
        trees = synth.random_trees(6, 30, 31, 10, grid_size=40)
        return trees, [i % 3 for i in range(30)], 3, \
            synth.random_rows(rng, 300, 10)
    if kind == "mslr":
        trees = synth.random_trees(8, 12, 255, 136, grid_size=60)
        return trees, [0] * 12, 1, synth.random_rows(rng, 200, 136)
    if kind == "wide":
        trees = synth.random_trees(10, 6, 31, 4000, grid_size=20)
        return trees, [0] * 6, 1, synth.random_rows(rng, 12, 4000)
    text, trees, feats = _forest("numeric" if kind == "one_row" else kind)
    rows = 1 if kind == "one_row" else 300
    return trees, [0] * len(trees), 1, _rows(kind, rows, feats, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "multiclass", "categorical",
                                  "deep", "one_row", "mslr", "mixed",
                                  "wide"])
def test_tree_shap_kernel_equals_plain_version(kind, cuda_device):
    from lambdagap_tpu_torch.models import shap
    trees, tc, K, X = _shap_case(kind)
    paths = shap.build_paths(trees, tc, K)
    plan = shap.launch_plan(paths, len(X), X.shape[1])
    if kind in ("deep", "mixed"):
        assert 250 < paths.max_elems <= 256 and paths.num_long >= 1
        assert np.count_nonzero(paths.path_value) == 1 + 310 * (
            kind == "mixed")
        assert plan["cuda_launches"] == 3       # grouped, long, reduction
    else:
        assert plan["cuda_launches"] == 2 and plan["long_cap"] == 0
    assert plan["staged"] == (kind != "wide")
    p = shap.to_device(paths, cuda_device)
    x = torch.from_numpy(X.astype(np.float64)).to(cuda_device)
    want = shap._tree_shap_reference(x, p)
    before = shap.TREE_SHAP_LAUNCHES.launches
    got = shap.tree_shap(x, p)
    again = shap.tree_shap(x, p)
    torch.cuda.synchronize()
    assert shap.TREE_SHAP_LAUNCHES.launches == before + 2
    assert got.shape == (len(X), K, X.shape[1] + 1)
    assert torch.equal(got, again)
    n = 2 if kind in ("deep", "mixed") else len(X)   # slow on the CPU
    cpu = shap._tree_shap_reference(x[:n].cpu(), shap.to_device(paths, "cpu"))
    np.testing.assert_allclose(got[:n].cpu().numpy(), cpu.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "multiclass", "mixed"])
def test_tree_shap_row_does_not_depend_on_its_batch(kind, cuda_device,
                                                    monkeypatch):
    """A row's contributions have the same bits alone, inside a batch and
    in a batch cut into passes (a small workspace budget)."""
    from lambdagap_tpu_torch.models import shap
    trees, tc, K, X = _shap_case(kind)
    paths = shap.build_paths(trees, tc, K)
    p = shap.to_device(paths, cuda_device)
    x = torch.from_numpy(X.astype(np.float64)).to(cuda_device)
    full = shap.tree_shap(x, p)
    for r in (0, 1, len(X) - 1):
        assert torch.equal(shap.tree_shap(x[r:r + 1], p), full[r:r + 1])
    slices = shap.launch_plan(paths, 1, X.shape[1])["chunks"] + K
    monkeypatch.setattr(shap, "SCRATCH_BYTES", slices * X.shape[1] * 8 * 5)
    plan = shap.launch_plan(paths, len(X), X.shape[1])
    assert plan["passes"] > 1 and plan["pass_rows"] <= 5
    assert torch.equal(shap.tree_shap(x, p), full)


@pytest.mark.cuda
def test_tree_shap_division_equals_ieee_division(cuda_device):
    """Kernel S divides by a reciprocal refined once a divisor; the
    quotient equals ``/`` bit for bit: every divisor of its table (1-32)
    and arbitrary divisors (the quotient it divides by), over numerators
    of every exponent, near multiples of the divisor, zeros, subnormals,
    infinities and NaN."""
    import ctypes
    from lambdagap_tpu_torch.models import shap
    lib = shap._kernel_lib()
    vp = ctypes.c_void_p
    lib.lg_tree_shap_div_check.argtypes = [vp, vp, ctypes.c_int64,
                                           ctypes.c_int, vp, vp, vp]
    lib.lg_tree_shap_div_check.restype = ctypes.c_int
    rng = np.random.RandomState(11)

    def bits(n):                # every float64 bit pattern, NaN included
        w = rng.randint(0, 1 << 32, (2, n), dtype=np.uint64)
        return (w[0] << np.uint64(32) | w[1]).view(np.float64)

    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                        -5e-324, 2.2250738585072014e-308, 1.0,
                        np.finfo(np.float64).max], np.float64)
    table = np.arange(1, 33, dtype=np.float64)
    nums = np.concatenate([
        bits(1 << 14),
        rng.rand(1 << 14), rng.rand(1 << 12) * 1e-300,
        np.ldexp(rng.rand(1 << 12), rng.randint(-1074, -1000, 1 << 12)),
        special])
    near = np.outer(rng.randint(1, 1 << 20, 256).astype(np.float64), table)
    near = np.concatenate([near, np.nextafter(near, 0), np.nextafter(
        near, np.inf)]).ravel()
    cases = [
        (1, np.repeat(nums, 32), np.tile(table, len(nums))),
        (1, near, np.tile(table, len(near) // 32)),
        (0, np.repeat(nums, 32), np.tile(table, len(nums))),
        (0, nums, bits(len(nums))),
        (0, np.repeat(nums[:4096], len(special)),
         np.tile(special, 4096)),
        (0, rng.rand(1 << 14), rng.rand(1 << 14) * 10.0 ** rng.randint(
            -300, 300, 1 << 14)),
    ]
    for positive, xs, ys in cases:
        x = torch.from_numpy(np.ascontiguousarray(xs)).to(cuda_device)
        y = torch.from_numpy(np.ascontiguousarray(ys)).to(cuda_device)
        q, ref = torch.empty_like(x), torch.empty_like(x)
        rc = lib.lg_tree_shap_div_check(
            x.data_ptr(), y.data_ptr(), len(x), positive, q.data_ptr(),
            ref.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(q.view(torch.int64), ref.view(torch.int64))
        with np.errstate(all="ignore"):
            host = xs / ys
        ok = ~np.isnan(host)
        assert np.array_equal(ref.cpu().numpy()[ok].view(np.int64),
                              host[ok].view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_pred_leaf_on_card_is_one_traversal_launch(kind, cuda_device):
    text, _trees, feats = _forest(kind)
    X = _rows(kind, 601, feats, seed=5)
    bst = lgt.Booster(model_str=text)
    bst.predict(X[:8], pred_leaf=True)            # compile and upload
    eng.TRAVERSE_LAUNCHES.reset()
    eng.ACCUMULATE_LAUNCHES.reset()
    eng.PREDICT_LAUNCHES.reset()
    got = bst.predict(X, pred_leaf=True)
    assert eng.TRAVERSE_LAUNCHES.launches == 1
    assert eng.ACCUMULATE_LAUNCHES.launches == 0
    assert eng.PREDICT_LAUNCHES.launches == 0
    tensor = lgt.Booster(model_str=text, params={"predict_engine": "tensor",
                                                 "predict_tree_tile": 5})
    assert np.array_equal(got, tensor.predict(X, pred_leaf=True))
    assert np.array_equal(got, lgt.Booster(model_str=text, params=CPU)
                          .predict(X, pred_leaf=True))


@pytest.mark.cuda
def test_tensor_engine_on_card_serves_the_scan_oracle(cuda_device):
    text, _trees, feats = _forest("categorical")
    X = _rows("categorical", 700, feats, seed=6)
    ref = lgt.Booster(model_str=text, params={"predict_engine": "scan"}
                      ).predict(X, raw_score=True)
    bst = lgt.Booster(model_str=text, params={"predict_engine": "tensor",
                                              "predict_tree_tile": 5})
    assert np.array_equal(bst.predict(X, raw_score=True), ref)
    with bst.as_server(raw_score=True) as server:
        assert np.array_equal(server.predict(X), ref)


# ---------------------------------------------------------------------------
# data_residency=stream: K1's accumulate mode, the rings, stream training
# and predict_stream on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 3, 7])
@pytest.mark.parametrize("case", ["root", "masked", "u16", "rows"])
def test_hist_accumulate_mode_on_card(case, windows, cuda_device):
    """K1 added over ``windows`` ragged windows of rows into one int64
    accumulator and finished once is ``torch.equal`` to one launch over
    the same rows, to the plain version of both, and to the plain
    accumulate mode; each window is one launch of the accumulate mode and
    the finish one more. ``rows``: each window read through its own slice
    of a permutation; otherwise the window's channels are its own (window
    mode, the stream layout's gathered channels)."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    dev = cuda_device
    bins, grad, hess, _, _, nb = _hist_case(
        "u16" if case == "u16" else "skewed", dev)
    n = bins.shape[0]
    gen = torch.Generator(device=dev).manual_seed(20 + windows)
    mask = (torch.rand(n, generator=gen, device=dev) < 0.7
            if case == "masked" else None)
    scale = hc.hist_scale(grad, hess)
    cuts = sorted(np.random.RandomState(windows).randint(
        1, n, windows - 1).tolist())
    edges = [0] + cuts + [n]
    perm = torch.randperm(n, generator=gen, device=dev).int()
    acc = hc.hist_acc(bins.shape[1], nb, dev)
    ref_acc = hc.hist_acc(bins.shape[1], nb, dev)
    before = (hc.HIST_STREAM_LAUNCHES.launches,
              hc.HIST_FINISH_LAUNCHES.launches, hc.HIST_LAUNCHES.launches)
    for lo, hi in zip(edges[:-1], edges[1:]):
        if case == "rows":
            args = (bins, grad, hess, perm[lo:hi], hi - lo, nb)
            m = None
        else:
            args = (bins[lo:hi], grad[lo:hi], hess[lo:hi], None, hi - lo, nb)
            m = None if mask is None else mask[lo:hi]
        hc.hist_rows_add(acc, *args, scale, m)
        hc._hist_add_reference(ref_acc, *args, m, None, scale)
    got = hc.hist_finish(acc, scale)
    after = (hc.HIST_STREAM_LAUNCHES.launches,
             hc.HIST_FINISH_LAUNCHES.launches, hc.HIST_LAUNCHES.launches)
    assert after[0] - before[0] == windows
    assert after[1] - before[1] == 1
    assert after[2] == before[2]
    assert int(acc.abs().sum()) == 0            # finish leaves it zero
    rows = perm if case == "rows" else None
    one = hc.hist_rows(bins, grad, hess, rows, n, nb, mask, scale=scale)
    plain = hc._hist_reference(bins, grad, hess, rows, n, nb, mask,
                               scale=scale)
    assert torch.equal(got, one)
    assert torch.equal(got, plain)
    assert torch.equal(hc._hist_finish_reference(ref_acc, scale), got)


class _SlowCopy:
    """A consumer that copies each window into its place in an output
    buffer after a spin on the card, so the ring's next copies run while
    earlier windows are still being read."""

    def __init__(self, n: int, cols: int, dev) -> None:
        self.out = torch.zeros((n, cols), dtype=torch.uint8, device=dev)
        self.idx = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def __call__(self, lo: int, bins, lanes) -> None:
        torch.cuda._sleep(20_000)
        self.out[lo:lo + bins.shape[0]] = bins
        self.idx[lo:lo + lanes.shape[0]] = lanes


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_shard_ring_on_card_reproduces_its_inputs(depth, cuda_device):
    """Many small windows of two buffers each (u8 bins and int32 lanes, a
    few empty) pumped through the H2D ring at ``depth`` slots, each read
    on the card behind a spin: every byte lands where it belongs. Then the
    D2H score ring at the same depth brings f32 and f64 tiles back equal."""
    from lambdagap_tpu_torch.data.stream import ShardRing, WindowPump
    from lambdagap_tpu_torch.infer.stream import ScoreRing
    dev = cuda_device
    rng = np.random.RandomState(depth)
    sizes = rng.randint(0, 3000, 60)
    sizes[::17] = 0
    n = int(sizes.sum())
    bins = rng.randint(0, 256, (n, 28)).astype(np.uint8)
    lanes = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ring = ShardRing(dev, depth)
    sink = _SlowCopy(n, 28, dev)

    def windows():
        for lo, w in zip(starts, sizes):
            yield int(lo), (bins[lo:lo + w], lanes[lo:lo + w])

    for lo, (b, la) in WindowPump(windows(), ring):
        sink(lo, b, la)
    torch.cuda.synchronize()
    assert np.array_equal(sink.out.cpu().numpy(), bins)
    assert np.array_equal(sink.idx.cpu().numpy(), lanes)
    assert ring.windows == len(sizes)

    sring = ScoreRing(dev, depth)
    tiles = [torch.randn((3, int(w)), dtype=dt, device=dev)
             for w, dt in zip(sizes, [torch.float32, torch.float64] * 30)]
    back = []

    def drain():
        k, h = sring.wait_ready()      # a view of the slot: copy it out
        back.append((k, h.copy()))

    for k, t in enumerate(tiles):
        torch.cuda._sleep(20_000)
        sring.put(k, t * 2)
        if sring.full:
            drain()
    while len(sring):
        drain()
    assert [k for k, _ in back] == list(range(len(tiles)))
    for (k, h), t in zip(back, tiles):
        assert np.array_equal(h, (t * 2).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {}, {"tree_layout": "sorted"}, {"tpu_fused_learner": "0"},
    {"tpu_fused_learner": "0", "tree_layout": "sorted"},
    {"data_sample_strategy": "goss", "learning_rate": 0.3},
    {"data_sample_strategy": "goss", "learning_rate": 0.3,
     "stream_goss_compact": False, "tree_layout": "sorted"},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "stream_prefetch_depth": 1},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "stream_prefetch_depth": 4,
     "tree_layout": "sorted"}])
def test_stream_training_on_card_equals_resident(extra, cuda_device):
    """data_residency=stream on the card (ragged 1,024-row shards) grows
    the resident model byte for byte up to ``end of trees``; every
    histogram of the stream run comes from K1's accumulate mode (windows
    and finishes counted), none from the resident launch."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(13)
    X = rng.randn(9000, 10)
    X[:, 9] = rng.randint(0, 6, 9000)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + (X[:, 9] == 3) > 0.3) \
        .astype(float)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "stream_shard_rows": 1024, **extra}
    texts = {}
    for mode in ("hbm", "stream"):
        counts = [hc.HIST_LAUNCHES.launches,
                  hc.HIST_STREAM_LAUNCHES.launches,
                  hc.HIST_FINISH_LAUNCHES.launches]
        bst = lgt.train({**params, "data_residency": mode},
                        lgt.Dataset(X, label=y, categorical_feature=[9]), 6)
        texts[mode] = bst.model_to_string().split("end of trees")[0]
        lr = bst._booster.learner
        resident, windows, finishes = (
            c.launches - b for c, b in zip(
                (hc.HIST_LAUNCHES, hc.HIST_STREAM_LAUNCHES,
                 hc.HIST_FINISH_LAUNCHES), counts))
        assert lr.residency == mode
        if mode == "stream":
            assert resident == 0
            assert finishes > 0 and windows >= finishes
            assert lr.x_rows is None
        else:
            assert windows == 0 and finishes == 0 and resident > 0
    assert texts["stream"] == texts["hbm"]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["compiled", "tensor", "scan"])
def test_predict_stream_on_card_equals_predict(engine, cuda_device):
    """predict_stream on the card at several windows and ring depths
    (ragged tails, a binned source) equals ``predict`` bit for bit; under
    ``compiled`` each window is one launch of the fused kernel."""
    rng = np.random.RandomState(14)
    X = rng.randn(5000, 8)
    y = (X[:, 0] - X[:, 3] > 0).astype(float)
    tr = lgt.Dataset(X, label=y)
    bst = lgt.train({"objective": "binary", "num_leaves": 31, "verbose": -1,
                     "predict_engine": engine}, tr, 8)
    Xv = rng.randn(3001, 8)
    want = bst.predict(Xv, raw_score=True)
    for window, depth in ((4096, 2), (512, 1), (333, 4)):
        bst._booster.config.predict_stream_depth = depth
        eng.PREDICT_LAUNCHES.reset()
        st = {}
        got = bst.predict_stream(Xv, raw_score=True, window_rows=window,
                                 stats_out=st)
        assert np.array_equal(got, want)
        if engine == "compiled":
            assert eng.PREDICT_LAUNCHES.launches == st["windows"]
    assert np.array_equal(bst.predict_stream(Xv, window_rows=700),
                          bst.predict(Xv))
    sv = lgt.ShardedBinnedDataset.from_matrix(
        Xv, bst._booster.config, shard_rows=1024, reference=tr.construct())
    assert np.array_equal(bst.predict_stream(sv, raw_score=True,
                                             window_rows=1000), want)


# ---------------------------------------------------------------------------
# the training API's boosting modes on the card: DART's histograms and its
# served model
# ---------------------------------------------------------------------------
def _dart_booster(rounds: int, device_params: dict, capture=None):
    """A DART booster (drop rate 0.9, every round drops) on 20,000 x 10;
    ``capture`` (a list) receives the inputs and output of the last
    round's first K1 launch."""
    from lambdagap_tpu_torch.ops import histogram as hmod
    rng = np.random.RandomState(8)
    X = rng.randn(20_000, 10)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    bst = lgt.Booster(params={"objective": "binary", "num_leaves": 31,
                              "verbose": -1, "boosting": "dart",
                              "drop_rate": 0.9, "skip_drop": 0.0,
                              **device_params},
                      train_set=lgt.Dataset(X, label=y))
    for _ in range(rounds - 1):
        bst.update()
    orig = hmod.hist_rows

    def spy(*args):
        out = orig(*args)
        if capture is not None and not capture:
            capture.append((args, out.clone()))
        return out
    hmod.hist_rows = spy
    try:
        bst.update()
    finally:
        hmod.hist_rows = orig
    return bst, X


@pytest.mark.cuda
def test_dart_round_histogram_equals_plain_version_on_card(cuda_device):
    """A DART round on the card, after its dropout changed the scores: the
    round's first leaf histogram (K1) is ``torch.equal`` to the plain
    version on the same inputs, every histogram of the run is one K1
    launch, and the booster's scores equal its trees' raw predictions."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    captured = []
    before = hc.HIST_LAUNCHES.launches
    bst, X = _dart_booster(4, {}, captured)
    gb = bst._booster
    assert gb.learner.x_rows.is_cuda and gb.tree_weight
    built = sum(t.num_leaves for t in gb.host_models)
    assert hc.HIST_LAUNCHES.launches - before == built
    (args, got), = captured
    assert args[0].is_cuda
    torch.cuda.synchronize()
    assert torch.equal(got, hc._hist_reference(*args))
    np.testing.assert_allclose(gb.scores[0].cpu().numpy(),
                               bst.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_served_dart_model_fused_launch_equals_plain_version(cuda_device):
    """A DART model trained on the card and served from it: one fused
    launch a dispatch, ``torch.equal`` to the fused kernel's plain version
    on the compiled tables, and the answers equal the CPU scan oracle's."""
    bst, X = _dart_booster(4, {})
    x = torch.from_numpy(np.ascontiguousarray(X[:4096], np.float32)).to(
        cuda_device)
    cf = bst._booster._compiled_forest(0, -1)
    eng.PREDICT_LAUNCHES.reset()
    got = cf.predict(x)
    assert eng.PREDICT_LAUNCHES.launches == 1
    assert torch.equal(got, _plain(cf, x))
    ref = lgt.Booster(model_str=bst.model_to_string(),
                      params={**CPU, "predict_engine": "scan"})
    with bst.as_server(raw_score=True) as server:
        served = server.predict(X[:4096])
    np.testing.assert_array_equal(served, got[0].cpu().numpy())
    np.testing.assert_allclose(served, ref.predict(X[:4096], raw_score=True),
                               rtol=1e-6, atol=1e-6)
