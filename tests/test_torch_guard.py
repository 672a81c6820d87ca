"""The non-finite guard (``guard/nonfinite.py``, ``guard_nonfinite``) on the
CPU, held to the JAX package's: the same inputs raise ``NonFiniteError``
in both packages under ``raise``, and give the same models under
``skip_tree`` and ``clip``. The guard's flag rides the learner's first
record read of a round, so it adds no host read to a round."""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt
from lambdagap_tpu.guard.nonfinite import NonFiniteError as JaxNonFinite
from lambdagap_tpu_torch.guard.nonfinite import NonFiniteError

CPU = {"device_type": "cpu"}
JAX_F32 = {"tpu_fused_learner": "1", "tpu_hist_impl": "onehot",
           "tpu_hist_precision": "f32"}
BASE = {"objective": "regression", "num_leaves": 7, "min_data_in_leaf": 5,
        "verbose": -1}


def _data(seed=3, n=1000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    return X, X[:, 0] + 0.5 * X[:, 1] + 0.1 * rng.randn(n)


def _poisson_blowup():
    """A poisson run whose second round's exp overflows: round 0 stays
    finite, every later round's hessians are infinite."""
    rng = np.random.RandomState(3)
    X = rng.randn(1000, 6)
    y = np.exp(X[:, 0] * 2 + X[:, 1]) * rng.poisson(1.0, 1000)
    return X, y, {"objective": "poisson", "num_leaves": 7,
                  "learning_rate": 2.9, "min_data_in_leaf": 5,
                  "verbose": -1}


def _nan_label():
    X, y = _data()
    y = y.copy()
    y[[3, 50, 700]] = np.nan
    return X, y


@pytest.mark.parametrize("case", ["nan_label", "poisson_overflow"])
def test_raise_in_both_packages(case):
    if case == "nan_label":
        X, y = _nan_label()
        params = BASE
    else:
        X, y, params = _poisson_blowup()
    with pytest.raises(JaxNonFinite):
        lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 4)
    with pytest.raises(NonFiniteError):
        lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 4)


def test_skip_tree_keeps_the_finite_rounds_like_jax():
    X, y, params = _poisson_blowup()
    params = {**params, "guard_nonfinite": "skip_tree"}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 5)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5)
    gj, gt = bj._booster, bt._booster
    assert len(gt.models) == len(gj.models) == 1
    assert gt.iter_ == gj.iter_ == 1 and gt.last_iteration_skipped
    assert np.isfinite(gt.scores.numpy()).all()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)


def test_clip_trains_like_jax():
    X, y = _nan_label()
    params = {**BASE, "guard_nonfinite": "clip", "boost_from_average": False}
    bj = lgb.train({**params, **JAX_F32}, lgb.Dataset(X, label=y), 5)
    bt = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 5)
    pt = bt.predict(X)
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt, bj.predict(X), rtol=1e-4, atol=1e-5)


def test_off_trains_on_like_the_unguarded_loop():
    X, y = _nan_label()
    bt = lgt.train({**BASE, **CPU, "guard_nonfinite": "off"},
                   lgt.Dataset(X, label=y), 2)
    assert len(bt._booster.models) == 2


def test_the_flag_rides_the_first_record_read():
    """A guarded round makes as many host reads as an unguarded one: the
    flag is read with the first tree's root step."""
    X, y = _data()
    syncs = {}
    for policy in ("off", "raise"):
        bst = lgt.train({**BASE, **CPU, "guard_nonfinite": policy},
                        lgt.Dataset(X, label=y), 3)
        syncs[policy] = bst._booster.learner.host_syncs
    assert syncs["off"] == syncs["raise"]


def _poked(policy):
    """Three finite rounds, then the scores made non-finite as if the third
    round's update had overflowed: no read has seen them yet."""
    X, y = _data()
    bst = lgt.train({**BASE, **CPU, "guard_nonfinite": policy},
                    lgt.Dataset(X, label=y), 3)
    clean = bst.predict(X, raw_score=True)
    bst._booster.scores[0, 5] = float("inf")
    bst._booster.guard._unchecked = True
    return X, bst, clean


def test_scores_left_non_finite_raise_in_the_next_round():
    X, bst, _ = _poked("raise")
    gb = bst._booster
    with pytest.raises(NonFiniteError, match="iteration 2"):
        bst.update()
    assert len(gb.models) == 3 and gb.iter_ == 3


def test_scores_left_non_finite_drop_that_round_and_regrow_it():
    """skip_tree restores the state from before the round that made the
    scores non-finite and grows it again (a deterministic run regrows the
    same tree)."""
    X, bst, clean = _poked("skip_tree")
    gb = bst._booster
    assert bst.update() is False
    assert len(gb.models) == 3 and gb.iter_ == 3
    assert np.isfinite(gb.scores.numpy()).all()
    np.testing.assert_array_equal(bst.predict(X, raw_score=True), clean)


@pytest.mark.parametrize("policy", ["raise", "skip_tree"])
def test_the_last_round_is_checked_when_training_ends(policy):
    X, bst, _ = _poked(policy)
    gb = bst._booster
    if policy == "raise":
        with pytest.raises(NonFiniteError):
            gb.guard_finish()
    else:
        assert gb.guard_finish() is True
        assert len(gb.models) == 2 and gb.iter_ == 2
        assert np.isfinite(gb.scores.numpy()).all()


def _update_loop(booster, error, rounds=5, blowup=2):
    """A bare ``update()`` loop whose round ``blowup`` runs at a learning
    rate of 1e39 (inf in float32: that round's leaf values, and so the
    scores it leaves, are non-finite while its gradients are finite); the
    rate is set back after it. Per call: the round's
    ``last_iteration_skipped``, or "raise" where the call raised."""
    seen = []
    for i in range(rounds):
        if i in (blowup, blowup + 1):
            booster.reset_parameter(
                {"learning_rate": 1e39 if i == blowup else 0.1})
        try:
            booster.update()
        except error:
            return seen + ["raise"]
        seen.append(bool(booster._booster.last_iteration_skipped))
    return seen


@pytest.mark.parametrize("policy", ["raise", "skip_tree"])
def test_bare_update_loop_checks_its_own_round_like_jax(policy):
    """Scores driven non-finite by round 2's update: the JAX package's
    ``update`` raises, or drops the round, in that same call; so does the
    port's, with no later call needed to find them."""
    X, y = _data()
    params = {**BASE, "guard_nonfinite": policy}
    bj = lgb.Booster(params={**params, **JAX_F32},
                     train_set=lgb.Dataset(X, label=y))
    bt = lgt.Booster(params={**params, **CPU},
                     train_set=lgt.Dataset(X, label=y))
    seen_j = _update_loop(bj, JaxNonFinite)
    seen_t = _update_loop(bt, NonFiniteError)
    if policy == "raise":
        assert seen_j == seen_t == [False, False, "raise"]
        return
    assert seen_j == seen_t == [False, False, True, False, False]
    gj, gt = bj._booster, bt._booster
    assert len(gt.models) == len(gj.models) == 4
    assert gt.iter_ == gj.iter_ == 4
    assert np.isfinite(gt.scores.numpy()).all()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-5)
