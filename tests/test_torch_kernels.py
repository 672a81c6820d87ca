"""The port's CUDA traversal kernel and the paths around it, on seeded
synthetic forests (no JAX: this file also runs on the card machine).

On the CPU: the plain traversal's leaf indices equal an independent
host walk of every tree (``Tree._decision``), and the compiled engine
equals the scan oracle bit for bit, hostile categorical values included.
On the card (``-m cuda``; skipped elsewhere): the kernel equals its plain
version with ``torch.equal`` at the serving bucket sizes and counts one
launch per call, and the compiled engine and the server on the card equal
the scan oracle on the card.

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
