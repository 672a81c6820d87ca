"""Bagging and GOSS (``models/sample_strategy``) held bit for bit to the
JAX package's ``models/sample_strategy.py`` on the same numpy grad/hess:
every mask, every sampled and amplified gradient, iteration by iteration,
including ``bagging_freq`` windows that reuse a mask, balanced bagging and
GOSS's ``int(1/learning_rate)`` warm-up. Both packages get the same numpy
gradients, so torch's and XLA's ``exp`` never enter."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.models import sample_strategy as jss
from lambdagap_tpu_torch.models import sample_strategy as pss
from lambdagap_tpu_torch.utils import prng


def _inputs(seed, n, k=1):
    rng = np.random.RandomState(seed)
    g = rng.randn(k, n).astype(np.float32)
    h = (np.abs(rng.randn(k, n)) + 0.05).astype(np.float32)
    y = (rng.rand(n) > 0.4).astype(np.float32)
    return g, h, y


def _run(params, n, iters, seed=0, k=1):
    """(JAX, port) outputs of ``sample`` over ``iters`` iterations."""
    g, h, y = _inputs(seed, n, k)
    sj = jss.create_sample_strategy(lgb.Config.from_params(params), n,
                                    label=y)
    st = pss.create_sample_strategy(lgt.Config.from_params(params), n,
                                    label=y)
    out = []
    for it in range(iters):
        gj, hj, mj = sj.sample(it, jnp.asarray(g), jnp.asarray(h))
        gt, ht, mt = st.sample(it, torch.from_numpy(g), torch.from_numpy(h))
        out.append(((np.asarray(gj), np.asarray(hj),
                     None if mj is None else np.asarray(mj)),
                    (gt.numpy(), ht.numpy(),
                     None if mt is None else mt.numpy())))
    return out


def _assert_same(out):
    for (gj, hj, mj), (gt, ht, mt) in out:
        assert (mj is None) == (mt is None)
        if mj is not None:
            np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.5, "bagging_freq": 3, "bagging_seed": 11},
    {"bagging_fraction": 0.9, "bagging_freq": 1, "bagging_seed": 0},
])
def test_bagging_masks_equal_jax(params):
    out = _run(params, 1003, 7)
    _assert_same(out)
    masks = [o[1][2] for o in out]
    freq = params["bagging_freq"]
    for it in range(1, 7):      # a mask is drawn once per freq window
        same = np.array_equal(masks[it], masks[it - 1])
        assert same == (it % freq != 0)
    frac = np.mean([m.mean() for m in masks])
    assert abs(frac - params["bagging_fraction"]) < 0.05


@pytest.mark.parametrize("freq", [1, 3])
def test_balanced_bagging_masks_equal_jax(freq):
    params = {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.3,
              "bagging_freq": freq}
    out = _run(params, 2000, 5, seed=1)
    _assert_same(out)
    _, _, y = _inputs(1, 2000)
    m = out[0][1][2]
    assert abs(m[y > 0].mean() - 0.6) < 0.06
    assert abs(m[y <= 0].mean() - 0.3) < 0.06


@pytest.mark.parametrize("params", [
    {"data_sample_strategy": "goss", "learning_rate": 0.3},
    {"data_sample_strategy": "goss", "learning_rate": 0.25, "top_rate": 0.3,
     "other_rate": 0.15, "bagging_seed": 5},
    {"boosting": "goss", "learning_rate": 0.5},
])
def test_goss_masks_and_amplified_gradients_equal_jax(params):
    warm = max(1, int(1.0 / params["learning_rate"]))
    out = _run(params, 1501, warm + 3)
    _assert_same(out)
    for it, (_, (gt, _, mt)) in enumerate(out):
        assert (mt is None) == (it < warm)       # the warm-up samples nothing
    g, _, _ = _inputs(0, 1501)
    gt, _, mt = out[-1][1]
    # kept rows carry their gradient, sampled rest rows an amplified one
    top = float(params.get("top_rate", 0.2))
    other = float(params.get("other_rate", 0.1))
    amp = np.float32((1.0 - top) / other)
    kept = gt[0][mt]
    ratio = kept / g[0][mt]
    assert np.all(np.isclose(ratio, 1.0, rtol=1e-6)
                  | np.isclose(ratio, amp, rtol=1e-6))
    assert np.isclose(ratio, amp, rtol=1e-6).any()
    assert not gt[0][~mt].any()


def test_goss_with_tied_scores_keeps_every_tie_like_jax():
    """GOSS's k-th score is a sort: ``score >= kth`` keeps every row tied
    with it, as the JAX package does."""
    n = 600
    g = np.ones((1, n), np.float32)
    g[0, ::3] = 2.0
    h = np.ones((1, n), np.float32)
    gj, hj, mj = jss._goss_mask(jnp.asarray(g), jnp.asarray(h),
                                jax.random.PRNGKey(9), 0.2, 0.1)
    gt, ht, mt = pss.goss_mask(torch.from_numpy(g), torch.from_numpy(h),
                               prng.PRNGKey(9), 0.2, 0.1)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert mt[::3].all()                  # all 200 tied top rows kept


def test_multiclass_gradients_share_one_mask():
    _assert_same(_run({"bagging_fraction": 0.6, "bagging_freq": 2}, 700, 4,
                      k=3))
    _assert_same(_run({"data_sample_strategy": "goss",
                       "learning_rate": 0.5}, 700, 4, k=3))
