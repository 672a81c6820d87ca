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
and refuses maps out of range;
a compiled dispatch on the card is one launch of each; the compiled engine
and the server on the card equal the scan oracle on the card; the f32
histogram kernel (K1)
is ``torch.equal`` to its plain version on every channel at chip_smoke's
shapes (a skewed and an extreme-gradient leaf among them) and at
MSLR-WEB30K's 136 features (several feature tiles), with and without an
in-bag mask, reruns bit-identically and refuses bad inputs; the
int8 histogram kernel (K2) is ``torch.equal`` to its plain version at six
shapes (a saturated and a skewed one among them) and on a rerun; both
read a leaf through an offset into its parent's slice exactly as through
the slice itself, and give every host thread its own sums when two build
histograms at once on one stream; the threefry draws and the quantized
levels on the card equal the CPU's bit for bit; and short trainings on the
card (f32,
quantized + bagging, GOSS, EFB, rankers: lambdarank targets,
rank_xendcg, positions with by-query bagging; and the objectives of the
multiclass slice: 7-class softmax with a categorical column, one-vs-all,
multiclass GOSS, the renewed L1 family, the log-link losses and weighted
cross_entropy_lambda) equal the same on the CPU, and a 7-class model
served on the card with early stop equals the scan oracle.

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
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
    16,383 records each."""
    if kind == "numeric":
        trees, feats = synth.random_trees(3, 12, 31, 10, grid_size=40), 10
    elif kind == "large":
        trees, feats = synth.random_trees(2, 2, 16384, 28), 28
    else:
        feats = 6
        trees = synth.categorical_trees(4, num_features=feats)
    text = booster_from_numpy(synth.header(feats), trees,
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
    text, _trees, feats = _forest(kind)
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    art = compile_forest(gb)
    cf = eng.CompiledForest(art, cuda_device)
    X = _rows(kind, 601, feats, seed=3)
    want = eng.CompiledForest(art, torch.device("cpu")).predict(
        torch.from_numpy(X))
    eng.TRAVERSE_LAUNCHES.reset()
    eng.ACCUMULATE_LAUNCHES.reset()
    got = cf.predict(torch.from_numpy(X).to(cuda_device))
    torch.cuda.synchronize()
    assert eng.TRAVERSE_LAUNCHES.launches == 1
    assert eng.ACCUMULATE_LAUNCHES.launches == 1
    assert torch.equal(got.cpu(), want)


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
