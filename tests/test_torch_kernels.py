"""The port's CUDA kernels and the paths around them, on seeded synthetic
forests and data (no JAX: this file also runs on the card machine).

On the CPU: the plain traversal's leaf indices equal an independent
host walk of every tree (``Tree._decision``), and the compiled engine
equals the scan oracle bit for bit, hostile categorical values included.
On the card (``-m cuda``; skipped elsewhere): the traversal kernel equals
its plain version with ``torch.equal`` at the serving bucket sizes and
counts one launch per call, and the compiled engine and the server on the
card equal the scan oracle on the card; the histogram kernel equals its
plain version at chip_smoke's four shapes, reruns bit-identically and
refuses bad inputs, and a short training on the card equals the same on
the CPU.

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.convert import booster_from_numpy
from lambdagap_tpu_torch.infer import compile_forest
from lambdagap_tpu_torch.infer import engine as eng
from lambdagap_tpu_torch.models import synth

CPU = {"device_type": "cpu"}


def _forest(kind):
    """(text, trees, features) of one synthetic forest, via the text
    round trip."""
    if kind == "numeric":
        trees, feats = synth.random_trees(3, 12, 31, 10, grid_size=40), 10
    else:
        feats = 6
        trees = synth.categorical_trees(4, num_features=feats)
    text = booster_from_numpy(synth.header(feats), trees,
                              CPU).model_to_string()
    return text, lgt.Booster(model_str=text, params=CPU)._booster.models, \
        feats


def _rows(kind, n, feats, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "numeric":
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
@pytest.mark.parametrize("kind", ["numeric", "categorical"])
@pytest.mark.parametrize("rows", [1, 8, 601, 4096])
def test_kernel_equals_plain_version_on_card(kind, rows, cuda_device):
    text, _trees, feats = _forest(kind)
    gb = lgt.Booster(model_str=text, params=CPU)._booster
    tables = eng.device_tables(compile_forest(gb), cuda_device)
    x = torch.from_numpy(_rows(kind, rows, feats)).to(cuda_device)
    before = eng.TRAVERSE_LAUNCHES.launches
    got = eng.traverse_forest(x, tables)
    torch.cuda.synchronize()
    assert eng.TRAVERSE_LAUNCHES.launches == before + 1
    assert torch.equal(got, eng._traverse_all_reference(x, tables))


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
    """chip_smoke's four K1 shapes (T2): the HIGGS root, a leaf behind a
    permutation slice with out-of-range ids past count, u16 bins with a
    ragged count, count 0."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 10_500_000 if shape in ("root", "leaf", "empty") else 100_003
    f, nb = (28, 256) if n > 100_003 else (8, 1024)
    bins = torch.randint(0, nb - 1, (n, f), generator=gen, device=dev,
                         dtype=torch.int32)
    bins = bins.to(torch.uint8 if nb <= 256 else torch.uint16)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev)
    if shape == "root":
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["root", "leaf", "u16", "empty"])
def test_hist_kernel_equals_plain_version_on_card(shape, cuda_device):
    """K1 against its plain version: the count channel equal, grad/hess
    within rtol 2e-3 / atol 1e-4 (the kernel sums in f32 by blocks, the
    plain version in f64), a rerun bit-identical, one launch counted."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    args = _hist_case(shape, cuda_device)
    before = hc.HIST_LAUNCHES.launches
    got = hc.hist_rows(*args)
    again = hc.hist_rows(*args)
    ref = hc._hist_reference(*args)
    torch.cuda.synchronize()
    assert hc.HIST_LAUNCHES.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[..., 2], ref[..., 2])
    assert torch.allclose(got[..., :2], ref[..., :2], rtol=2e-3, atol=1e-4)
    if shape == "empty":
        assert not got.any()


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
    rtol 1e-4 / atol 1e-5 — thresholds tied across bins that hold no
    training row may break either way between f32 and f64 sums, and route
    no training row differently."""
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
