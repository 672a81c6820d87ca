"""The port's ranking objectives, metrics, query groups and by-query
bagging, held to the JAX package on the same numpy inputs.

Bars:
* lambdas / hessians of every ``lambdarank_target`` x ``lambdarank_norm``
  against the JAX package's ``_lambdarank_bucket`` at rtol 1e-5 / atol
  1e-7 — the JAX package's own dense-vs-tiled bar (``test_rank.py``): the
  port takes ``exp`` / ``log2`` and the lattice sums in float64, XLA in
  float32, so the last bits differ;
* the port's tiled sweep against its dense lattice at the same bar, and its
  query chunks against one chunk at rtol 1e-6;
* bucket index arrays, max (B)DCG, threefry uniforms and the by-query
  bagging mask exactly; xendcg's gradients at rtol 1e-5 / atol 1e-7;
* ndcg / map / precision (the same float64 numpy code) at rtol 1e-12.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
from lambdagap_tpu.config import LAMBDARANK_TARGETS
from lambdagap_tpu.config import Config as JaxConfig
from lambdagap_tpu.data.dataset import Metadata as JaxMetadata
from lambdagap_tpu.metrics import create_metrics as jax_metrics
from lambdagap_tpu.models import sample_strategy as jss
from lambdagap_tpu.objectives import rank as jrank
import lambdagap_tpu_torch as lgt
from lambdagap_tpu_torch.config import Config
from lambdagap_tpu_torch.data.dataset import Metadata
from lambdagap_tpu_torch.metrics import create_metrics
from lambdagap_tpu_torch.models import sample_strategy as pss
from lambdagap_tpu_torch.objectives import rank as prank
from lambdagap_tpu_torch.utils import prng

CPU = torch.device("cpu")


def _bucket(nq, L, lengths, seed, labels_hi=4, ties=True):
    """A padded bucket: scores (rounded, so ties occur), graded labels, a
    validity mask with ragged lengths, random inverse max (B)DCGs."""
    rng = np.random.RandomState(seed)
    s = rng.randn(nq, L).astype(np.float32)
    if ties:
        s = np.round(s, 1)
    lab = rng.randint(0, labels_hi + 1, (nq, L)).astype(np.float32)
    v = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    imd = rng.rand(nq).astype(np.float32)
    imb = rng.rand(nq).astype(np.float32)
    gains = (2.0 ** np.arange(labels_hi + 1) - 1).astype(np.float32)
    return s, lab, v, imd, imb, gains


def _port_bucket(arrs, **kw):
    s, lab, v, imd, imb, gains = arrs
    return [a.numpy() for a in prank._lambdarank_bucket(
        torch.from_numpy(s), torch.from_numpy(lab), torch.from_numpy(v),
        torch.from_numpy(imd), torch.from_numpy(imb),
        torch.from_numpy(gains), **kw)]


def _jax_bucket(arrs, **kw):
    s, lab, v, imd, imb, gains = arrs
    return [np.asarray(a) for a in jrank._lambdarank_bucket(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(v), jnp.asarray(imd),
        jnp.asarray(imb), jnp.asarray(gains), **kw)]


def _close(got, want, rtol=1e-5, atol=1e-7):
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("target", LAMBDARANK_TARGETS)
def test_lambdas_equal_jax(target, norm):
    """Every target, both norms, one bucket of ragged queries (one with a
    single document, one full), scores with ties."""
    arrs = _bucket(6, 32, [32, 20, 9, 1, 17, 26], seed=3)
    kw = dict(target=target, sigmoid=1.5, norm=norm, truncation_level=5,
              lambdagap_weight=0.5)
    got = _port_bucket(arrs, **kw)
    _close(got, _jax_bucket(arrs, **kw))
    assert np.abs(got[0]).sum() > 0          # the target moved something
    assert np.all(got[0][~arrs[2]] == 0) and np.all(got[1][~arrs[2]] == 0)


@pytest.mark.parametrize("target", ["ndcg", "ranknet", "lambdagap-x",
                                    "arpk", "lambdaloss-ndcg-plus-plus"])
def test_tiled_sweep_equals_dense(target):
    """The port's row-tiled sweep against its dense lattice (the JAX
    package's own test's shapes), and both against the JAX package."""
    arrs = _bucket(3, 256, [256, 200, 37], seed=7, labels_hi=3, ties=False)
    kw = dict(target=target, sigmoid=1.0, norm=True, truncation_level=20,
              lambdagap_weight=0.5)
    dense = _port_bucket(arrs, tile=None, **kw)
    _close(_port_bucket(arrs, tile=64, **kw), dense)
    _close(dense, _jax_bucket(arrs, tile=None, **kw))


def test_tiled_sweep_refuses_a_non_divisor_tile():
    arrs = _bucket(1, 64, [64], seed=1)
    with pytest.raises(ValueError, match="must divide"):
        _port_bucket(arrs, target="ndcg", sigmoid=1.0, norm=True,
                     truncation_level=5, lambdagap_weight=1.0, tile=48)


@pytest.mark.parametrize("target", ["ndcg", "lambdagap-x-plus-plus"])
@pytest.mark.parametrize("tile", [None, 16])
def test_query_chunks_equal_one_chunk(target, tile):
    """Queries split into chunks of few pair entries give one chunk's
    lambdas."""
    arrs = _bucket(9, 64, [64, 3, 50, 64, 1, 33, 40, 64, 12], seed=5)
    kw = dict(target=target, sigmoid=1.0, norm=True, truncation_level=10,
              lambdagap_weight=0.5, tile=tile)
    whole = _port_bucket(arrs, chunk_pairs=1 << 30, **kw)
    _close(_port_bucket(arrs, chunk_pairs=64 * 64 * 2, **kw), whole,
           rtol=1e-6, atol=0)
    _close(_port_bucket(arrs, chunk_pairs=1, **kw), whole, rtol=1e-6, atol=0)


def test_tile_rule_equals_jax():
    for L in (8, 4096, 8192, 16384, 1 << 20, 1 << 26):
        want = None if L <= jrank._DENSE_PAIR_L else max(
            (jrank._DENSE_PAIR_L ** 2) // L, 64)
        assert prank.tile_for(L) == want
        assert want is None or L % want == 0


def test_query_buckets_equal_jax():
    lengths = [1, 8, 9, 25, 7, 16, 17, 0, 300, 4097, 64, 3]
    qb = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    n = int(qb[-1])
    jb, pb = jrank._QueryBuckets(qb, n), prank._QueryBuckets(qb, n)
    assert pb.num_queries == jb.num_queries
    assert len(pb.buckets) == len(jb.buckets)
    for (L1, q1, i1), (L2, q2, i2) in zip(pb.buckets, jb.buckets):
        assert L1 == L2
        np.testing.assert_array_equal(q1, q2)
        assert i1.dtype == i2.dtype
        np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_dcg_equal_jax(seed):
    rng = np.random.RandomState(seed)
    gains = np.asarray(Config().label_gain_or_default(4))
    for n in (1, 5, 30, 200):
        lab = rng.randint(0, 5, n).astype(np.float32)
        if seed == 2:
            lab[:] = 0
        for k in (1, 3, 10, 30, 1000):
            assert prank.max_dcg_at_k(lab, k, gains) == \
                jrank.max_dcg_at_k(lab, k, gains)
            assert prank.max_bdcg_at_k(lab, k) == \
                jrank.max_bdcg_at_k(lab, k)


def test_xendcg_uniforms_equal_jax():
    """The per-iteration key, its fold_in by the bucket length and the split
    into one key per query draw jax.random's bits."""
    nq, L = 11, 32
    kj = jax.random.split(jax.random.PRNGKey(0))[1]
    kt = prng.split(prng.PRNGKey(0))[1]
    fj, ft = jax.random.fold_in(kj, L), prng.fold_in(kt, L)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    uj = jax.vmap(lambda k: jax.random.uniform(k, (L,)))(
        jax.random.split(fj, nq))
    ut = prng.uniform(prng.split(ft, nq), L)
    assert torch.equal(ut, torch.from_numpy(np.array(uj)))


@pytest.mark.parametrize("L, lengths", [(32, [32, 20, 9, 1, 17, 26]),
                                        (8, [8, 1, 3])])
def test_xendcg_gradients_equal_jax(L, lengths):
    s, lab, v, _, _, _ = _bucket(len(lengths), L, lengths, seed=4)
    kj = jax.random.fold_in(jax.random.PRNGKey(9), L)
    kt = prng.fold_in(prng.PRNGKey(9), L)
    want = [np.asarray(a) for a in jrank._xendcg_bucket(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(v), kj)]
    got = [a.numpy() for a in prank._xendcg_bucket(
        torch.from_numpy(s), torch.from_numpy(lab), torch.from_numpy(v),
        kt)]
    _close(got, want)


def _objective_pair(params, label, qb, position=None):
    jo = jrank.LambdarankNDCG if params["objective"] == "lambdarank" \
        else jrank.RankXENDCG
    j = jo(JaxConfig.from_params(params))
    j.init(JaxMetadata(label=label, query_boundaries=qb, position=position),
           len(label))
    p = prank.LambdarankNDCG if params["objective"] == "lambdarank" \
        else prank.RankXENDCG
    t = p(Config.from_params(params))
    t.init(Metadata(label=label, query_boundaries=qb, position=position),
           len(label), CPU)
    return j, t


@pytest.mark.parametrize("params", [
    {"objective": "lambdarank"},
    {"objective": "lambdarank", "lambdarank_target": "lambdagap-x-plus-plus",
     "lambdagap_weight": 0.5, "_weight": True},
    {"objective": "rank_xendcg"},
    {"objective": "lambdarank", "_position": True},
])
def test_objective_rounds_equal_jax(params):
    """The whole bucket loop (several buckets, a 1-document query, weights,
    positions) over three rounds of the same scores: gradients at the
    lattice bar, the position-bias vector at rtol 1e-5."""
    params = dict(params)
    weighted = params.pop("_weight", False)
    positioned = params.pop("_position", False)
    rng = np.random.RandomState(2)
    sizes = np.asarray([1, 7, 9, 30, 64, 65, 12, 5, 40])
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(qb[-1])
    label = rng.randint(0, 5, n).astype(np.float32)
    pos = (np.concatenate([np.arange(k) for k in sizes]).astype(np.int32)
           if positioned else None)
    j, t = _objective_pair(params, label, qb, pos)
    if weighted:
        w = (rng.rand(n) + 0.5).astype(np.float32)
        j.weight, t.weight = jnp.asarray(w), torch.from_numpy(w)
    for r in range(3):
        s = np.round(rng.randn(1, n), 1 if r == 0 else 3).astype(np.float32)
        gj, hj = (np.asarray(a) for a in j.get_gradients_fast(
            jnp.asarray(s)))
        gt, ht = (a.numpy() for a in t.get_gradients_fast(
            torch.from_numpy(s)))
        _close([gt, ht], [gj, hj])
        if positioned:
            np.testing.assert_allclose(t.pos_biases.numpy(),
                                       np.asarray(j.pos_biases), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("target", ["ndcg", "ranknet"])
def test_long_query_takes_the_tiled_sweep_like_jax(target):
    """A 5,000-document query pads to 8,192 and takes the row-tiled sweep
    (tile 2,048) in both packages; a 3-document query rides along."""
    rng = np.random.RandomState(8)
    qb = np.asarray([0, 5000, 5003], np.int32)
    label = rng.randint(0, 3, 5003).astype(np.float32)
    params = {"objective": "lambdarank", "lambdarank_target": target}
    j, t = _objective_pair(params, label, qb)
    assert [L for L, _, _ in t.bucketing.buckets] == [8, 8192]
    assert prank.tile_for(8192) == 2048
    s = rng.randn(1, 5003).astype(np.float32)
    gj, hj = (np.asarray(a) for a in j.get_gradients_fast(jnp.asarray(s)))
    gt, ht = (a.numpy() for a in t.get_gradients_fast(torch.from_numpy(s)))
    _close([gt, ht], [gj, hj])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fraction", [0.5, 0.8])
def test_bagging_by_query_mask_equals_jax(seed, fraction):
    """One uniform per query, every row of a query in or out together: the
    JAX package's mask, round after round."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, 40, 50)
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(qb[-1])
    params = {"bagging_fraction": fraction, "bagging_freq": 1,
              "bagging_by_query": True, "bagging_seed": 3 + seed}
    sj = jss.create_sample_strategy(lgb.Config.from_params(params), n,
                                    query_boundaries=qb)
    st = pss.create_sample_strategy(lgt.Config.from_params(params), n,
                                    query_boundaries=qb)
    g = rng.randn(1, n).astype(np.float32)
    h = np.abs(rng.randn(1, n)).astype(np.float32)
    for it in range(4):
        gj, hj, mj = sj.sample(it, jnp.asarray(g), jnp.asarray(h))
        gt, ht, mt = st.sample(it, torch.from_numpy(g), torch.from_numpy(h))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        m = mt.numpy()
        for q in range(len(sizes)):
            assert len(set(m[qb[q]:qb[q + 1]].tolist())) <= 1


@pytest.mark.parametrize("names", [["ndcg"], ["map"], ["precision"],
                                   ["ndcg", "map", "precision"], []])
@pytest.mark.parametrize("eval_at", [[1, 3, 5, 10], [], [2, 40]])
def test_rank_metrics_equal_jax(names, eval_at):
    """Through both packages' create_metrics: the same names, values and
    direction; ties in the scores, a query with no relevant document and
    an empty query; ``[]`` is lambdarank's default metric."""
    rng = np.random.RandomState(5)
    sizes = np.asarray([25, 1, 0, 13, 60, 7, 30])
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(qb[-1])
    label = rng.randint(0, 5, n).astype(np.float32)
    label[qb[3]:qb[4]] = 0
    scores = np.round(rng.randn(n), 1)
    params = {"objective": "lambdarank", "metric": names, "eval_at": eval_at}
    jm = jax_metrics(JaxConfig.from_params(params),
                     JaxMetadata(label=label, query_boundaries=qb), n)
    pm = create_metrics(Config.from_params(params),
                        Metadata(label=label, query_boundaries=qb), n)
    assert [m.name for m in pm] == [m.name for m in jm]
    for a, b in zip(pm, jm):
        assert a.greater_is_better and b.greater_is_better
        ra, rb = a.eval(scores), b.eval(scores)
        assert [k for k, _ in ra] == [k for k, _ in rb]
        np.testing.assert_allclose([v for _, v in ra], [v for _, v in rb],
                                   rtol=1e-12)


def test_group_sizes_and_query_ids_give_the_same_boundaries():
    sizes = np.asarray([3, 1, 4, 1, 5])
    n = int(sizes.sum())
    qid = np.repeat([7, 2, 9, 4, 8], sizes)
    label = np.zeros(n, np.float32)
    a, b, c = (Metadata(label=label), Metadata(label=label),
               JaxMetadata(label=label))
    a.set_group(sizes)
    b.set_group(qid)
    c.set_group(sizes)
    np.testing.assert_array_equal(a.query_boundaries, b.query_boundaries)
    np.testing.assert_array_equal(a.query_boundaries, c.query_boundaries)
    assert a.query_boundaries.dtype == np.int32 and a.num_queries == 5
    X = np.random.RandomState(0).randn(n, 3)
    d1 = lgt.Dataset(X, label=label, group=sizes).construct(
        Config.from_params({"min_data_in_bin": 1}))
    d2 = lgt.Dataset(X, label=label, group=qid).construct(
        Config.from_params({"min_data_in_bin": 1}))
    np.testing.assert_array_equal(d1.metadata.query_boundaries,
                                  d2.metadata.query_boundaries)
    ds = lgt.Dataset(X, label=label, group=sizes)
    np.testing.assert_array_equal(ds.get_group(), sizes)
    ds.construct(Config())
    np.testing.assert_array_equal(ds.get_group(), sizes)


def test_query_counts_must_cover_the_rows():
    md = Metadata(label=np.zeros(5, np.float32))
    md.set_group([2, 2])
    with pytest.raises(Exception, match="query counts"):
        md.check(5)
    md = Metadata(label=np.zeros(5, np.float32),
                  position=np.zeros(4, np.int32))
    with pytest.raises(Exception, match="position"):
        md.check(5)


def test_ranking_without_groups_refuses():
    X = np.random.RandomState(0).randn(40, 3)
    with pytest.raises(Exception, match="query information"):
        lgt.train({"objective": "lambdarank", "device_type": "cpu",
                   "verbose": -1}, lgt.Dataset(X, label=np.zeros(40)), 1)
