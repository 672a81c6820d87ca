"""Device-resident compiled forest with padding buckets.

The port of ``lambdagap_tpu/serve/cache.py``'s ``CompiledForestCache``:
the booster's forest is lowered and uploaded ONCE (it stays resident on
the card), and every request batch is cut into a small set of fixed
padding buckets (default 1/8/64/512/4096 rows) — the plan the JAX package
uses to hit pre-compiled executables. The port has no executables to
warm, but keeps the same plan so a request is dispatched in the same
chunks, the per-bucket accounting reads the same, and ``warm`` still pays
the one-time kernel build before the first request.

The engine is the booster's ``predict_engine``: ``compiled`` serves the
compiled artifact (the traversal and accumulation kernels), ``tensor``
the stacked tables in ``predict_tree_tile`` tiles through the tensorized
engine, ``scan`` the per-tree oracle.

Numerics: a bucket dispatch runs the exact device ops of
``GBDT.predict_raw`` on the same engine, and rows are independent, so
padded batches return bit-identical outputs to a direct
``Booster.predict``.

:class:`ModelPack` extends the buckets ACROSS models
(``serve_pack_models``): the resident compiled members merge into one
:class:`~lambdagap_tpu_torch.infer.engine.PackedForests`, and a mixed
batch pays one fused-kernel launch per padded bucket instead of one per
model.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.gbdt import dispatch_forest_predict
from ..ops.predict import forest_to_arrays
from ..ops.predict_tensor import build_tree_tiles
from ..utils import log

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)


def _plan(buckets, n: int):
    """Greedy (rows, bucket) decomposition: full buckets dispatch
    unpadded, a padded dispatch is only taken when its bucket is at most 2x
    the remaining rows (or nothing smaller fits)."""
    out = []
    rem = n
    while rem > 0:
        b_pad = next((b for b in buckets if b >= rem), None)
        b_full = next((b for b in reversed(buckets) if b <= rem), None)
        if b_pad is not None and (b_full is None or b_pad <= 2 * rem):
            out.append((rem, b_pad))
            rem = 0
        else:
            out.append((b_full, b_full))
            rem -= b_full
    return out


class CompiledForestCache:
    """One booster generation, compiled for serving on the booster's
    device.

    Parameters
    ----------
    gbdt: models.gbdt.GBDT — the loaded booster.
    buckets: padded batch sizes (sorted, deduped).
    start_iteration / num_iteration: forest slice, as in ``predict``.
    generation: serving generation id stamped on every response.
    stats: optional ``ServeStats`` for cache accounting.
    artifact_store: optional ``infer.ArtifactStore`` — under
        ``predict_engine=compiled`` the build consults it by source key
        before paying a local forest compile (a peer may have shipped the
        artifact already) and publishes local compiles into it;
        admissions vs local compiles are counted in ``ServeStats``.
    """

    def __init__(self, gbdt, buckets: Optional[Sequence[int]] = None,
                 start_iteration: int = 0, num_iteration: int = -1,
                 generation: int = 0, stats=None,
                 artifact_store=None) -> None:
        self.gbdt = gbdt
        self.device = gbdt.device
        self.generation = int(generation)
        self.start_iteration = int(start_iteration)
        self.num_iteration = int(num_iteration)
        self.stats = stats
        bl = tuple(sorted({int(b) for b in (buckets or DEFAULT_BUCKETS)
                           if int(b) > 0}))
        if not bl:
            raise ValueError("serve needs at least one positive bucket size")
        self.buckets = bl
        # any in-place mutation of the booster bumps its generation
        # (``GBDT.invalidate_predict_cache``): a pack keyed on this never
        # serves a stale forest
        self.key = (gbdt.generation, self.start_iteration,
                    self.num_iteration)
        idx = gbdt._model_slice(start_iteration, num_iteration)
        trees = [gbdt._tree(i) for i in idx]
        self.idx = idx
        self.num_class = gbdt.num_tree_per_iteration
        # matrix width the forest reads: 1 + max split feature. Wider
        # request rows are truncated, narrower ones padded by the server
        # under predict_disable_shape_check.
        self.width = max(1, 1 + max(
            (max(t.split_feature[:t.num_internal], default=0)
             for t in trees), default=0)) if trees else 1
        self.engine = gbdt.config.predict_engine
        cfg = gbdt.config
        self._es_freq = gbdt._es_freq()
        self._es_margin = float(cfg.pred_early_stop_margin)
        self._n_iters = max(1, len(idx) // max(self.num_class, 1))
        self._forest = None
        self.artifact = None
        self.artifact_hash = None
        self._compiled = None
        if idx and self.engine in ("scan", "tensor"):
            if any(getattr(t, "is_linear", False) for t in trees):
                raise NotImplementedError(
                    "linear-leaf forests are not ported to "
                    "lambdagap_tpu_torch yet (ROADMAP.md, port queue: "
                    "linear leaves)")
            forest, depth = forest_to_arrays(trees, device=self.device)
            tree_class = [i % self.num_class for i in idx]
            tiles = (build_tree_tiles(forest, tree_class,
                                      cfg.predict_tree_tile)
                     if self.engine == "tensor" else None)
            self._forest = (forest, depth, tree_class, tiles)
        elif idx:
            from ..infer import CompiledForest, compile_forest, source_key_of
            art = None
            if artifact_store is not None:
                art = artifact_store.get(
                    source_key_of(gbdt, start_iteration, num_iteration))
            if art is not None:
                if stats is not None:
                    stats.record_compile_shared()
            else:
                art = compile_forest(gbdt, start_iteration, num_iteration)
                if artifact_store is not None:
                    artifact_store.put(art)
                if stats is not None:
                    stats.record_compile_local()
            self.artifact = art
            self.artifact_hash = art.hash
            self._compiled = CompiledForest(
                art, self.device, early_stop_freq=self._es_freq,
                early_stop_margin=self._es_margin)
        self._warm: set = set()
        self._warm_lock = threading.Lock()
        self.build_time_s = 0.0
        if stats is not None:
            stats.record_forest_build()

    @property
    def hbm_bytes(self) -> int:
        """Resident device bytes of this forest: the compiled engine's
        tables, records and leaf table (``CompiledForest.nbytes``), or the
        scan / tensor engines' stacked arrays and tiles. The registry
        charges this against ``serve_hbm_budget_mb``."""
        if self._compiled is not None:
            return int(self._compiled.nbytes)
        seen, total = set(), 0
        stack = list(self._forest or ())
        while stack:
            a = stack.pop()
            if isinstance(a, torch.Tensor):
                if id(a) not in seen:
                    seen.add(id(a))
                    total += int(a.nbytes)
            elif isinstance(a, (tuple, list)):
                stack.extend(a)
        return total

    # ------------------------------------------------------------------
    def bucket_of(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows (requests larger than the
        top bucket are chunked by the caller)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def plan(self, n: int):
        """Greedy decomposition of ``n`` rows into (rows, bucket)
        dispatches; padding waste per batch stays under 2x."""
        return _plan(self.buckets, n)

    def _dispatch(self, xb: torch.Tensor, raw_score: bool) -> torch.Tensor:
        """One padded bucket through the forest: [num_class, B]."""
        if self._compiled is not None:
            out = self._compiled.predict(xb)
        else:
            forest, depth, tree_class, tiles = self._forest
            out = dispatch_forest_predict(
                self.gbdt.config, xb, forest, tree_class, self.num_class,
                depth, binned=False, early_stop_freq=self._es_freq,
                early_stop_margin=self._es_margin, blocks=tiles)
        return self._finish(out, raw_score)

    def _finish(self, out: torch.Tensor, raw_score: bool) -> torch.Tensor:
        """The dispatch's tail on raw scores [num_class, B]: averaging and
        the objective's conversion (a pack runs it per member, op for op,
        through :class:`PackMember`)."""
        return finish_scores(out, raw_score, self.gbdt.average_output,
                             self._n_iters, self.gbdt.objective)

    def predict(self, X: np.ndarray, raw_score: bool = False,
                record: bool = True) -> np.ndarray:
        """Predict [N, width] float32 rows; returns [N] (one class) or
        [N, K], matching ``Booster.predict`` bit for bit. N is chunked by
        the bucket plan, each chunk padded up to its bucket with zero rows
        that are sliced off after."""
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        if X.ndim != 2:
            raise ValueError(f"serve predict expects 2-D rows, got {X.shape}")
        N = X.shape[0]
        K = self.num_class
        if (self._forest is None and self._compiled is None) or N == 0:
            res = np.zeros((K, N), dtype=np.float32)
            return res[0] if K == 1 else res.T
        parts = []
        lo = 0
        for n, b in self.plan(N):
            chunk = X[lo:lo + n]
            lo += n
            if n < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - n, X.shape[1]), np.float32)])
            with self._warm_lock:        # parallel batch workers share this
                hit = b in self._warm
                if not hit:
                    self._warm.add(b)
            if record and self.stats is not None:
                self.stats.record_cache(hit, bucket=b)
            if not hit and self.stats is not None:
                self.stats.record_bucket_compile(b)
            # xb stays referenced until the result is on the host, so the
            # kernel's input outlives its (asynchronous) launch
            xb = torch.from_numpy(chunk).to(self.device)
            parts.append(self._dispatch(xb, raw_score)[:, :n].cpu().numpy())
        res = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return res[0] if K == 1 else res.T

    def warm(self) -> float:
        """Run every bucket once on zero rows (on the card this builds the
        traversal kernel at first use), so the first real request of any
        size pays no one-time cost. Returns the time spent (also kept as
        ``build_time_s``); warm dispatches do not count toward hit/miss
        stats."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.predict(np.zeros((b, self.width), np.float32), record=False)
        self.build_time_s = time.perf_counter() - t0
        log.info("serve: warmed %d padding buckets %s in %.2fs "
                 "(generation %d, %d trees, %s engine, %s)",
                 len(self.buckets), list(self.buckets), self.build_time_s,
                 self.generation, len(self.idx), self.engine, self.device)
        return self.build_time_s


def finish_scores(out: torch.Tensor, raw_score: bool, average_output: bool,
                  n_iters: int, objective) -> torch.Tensor:
    """Averaging and the objective's conversion of raw scores
    [num_class, B]: the tail of every serving dispatch. The average
    divides by a device tensor: CUDA multiplies by the reciprocal of a
    Python scalar divisor, which is not ``Booster.predict``'s host
    division to the last bit."""
    if average_output:
        out = out / torch.tensor(float(n_iters), dtype=out.dtype,
                                 device=out.device)
    if not raw_score and objective is not None:
        out = objective.convert_output(out)
    return out


class PackMember(NamedTuple):
    """What a pack keeps of one member cache: its identity (``generation``,
    ``key``), its request shape and its dispatch tail — not the cache, so
    an evicted or swapped-out member's device forest is freed."""
    generation: int
    key: tuple
    num_class: int
    width: int
    disable_shape_check: bool
    average_output: bool
    n_iters: int
    objective: object

    @classmethod
    def of(cls, cache: "CompiledForestCache") -> "PackMember":
        g = cache.gbdt
        return cls(cache.generation, cache.key, cache.num_class, cache.width,
                   bool(g.config.predict_disable_shape_check),
                   bool(g.average_output), cache._n_iters, g.objective)

    def finish(self, out: torch.Tensor, raw_score: bool) -> torch.Tensor:
        return finish_scores(out, raw_score, self.average_output,
                             self.n_iters, self.objective)


class ModelPack:
    """Padding buckets extended ACROSS models (``serve_pack_models``).

    The port of the JAX package's ``ModelPack``: the resident compiled
    member caches merge into ONE
    :class:`~lambdagap_tpu_torch.infer.engine.PackedForests`; a mixed batch
    concatenates into shared padding buckets with a per-row member index,
    and each bucket is one launch of the fused kernel's packed mode (one
    ``packed_dispatches`` in ``ServeStats``). Only each member's averaging
    / objective conversion (its cache's ``_finish``, op for op) runs per
    member afterwards. The pack keeps a :class:`PackMember` of each member
    (``members``), never the member cache.

    Bit-identity: each row's raw scores from the packed launch are its
    member's served alone (a foreign group's trees add an exact +0.0), so
    every output equals the member cache's ``predict`` of the same rows.

    Members must be compiled-engine caches without prediction early stop,
    all on one device; the server rebuilds the pack whenever membership or
    any member's serving generation or booster generation changes
    (:meth:`key_of`). (The JAX package keys its packs on the booster
    generation alone, which a swapped-in booster also starts at 0, so its
    pack keeps serving the forest a swap replaced.)
    """

    def __init__(self, members, buckets: Optional[Sequence[int]] = None,
                 stats=None) -> None:
        from ..infer import PackedForests
        if not members:
            raise ValueError("ModelPack needs at least one member cache")
        for name, c in members.items():
            if c._compiled is None:
                raise ValueError(
                    f"model {name!r} has no compiled forest (pack members "
                    "need predict_engine=compiled and a nonempty tree slice)")
            if c._es_freq:
                raise ValueError(
                    f"model {name!r} uses prediction early stop; packs "
                    "cannot replay a per-model tree-count stop")
        self.stats = stats
        self.packed = PackedForests(
            {n: c._compiled for n, c in members.items()})
        self.members = {n: PackMember.of(c) for n, c in members.items()}
        self.device = self.packed.device
        self.width = self.packed.width
        bl = tuple(sorted({int(b) for b in (buckets or DEFAULT_BUCKETS)
                           if int(b) > 0}))
        self.buckets = bl or DEFAULT_BUCKETS
        self.key = self.key_of(self.members)
        self._warm: set = set()
        self._warm_lock = threading.Lock()

    @staticmethod
    def key_of(members) -> frozenset:
        """What a pack of these member caches (or :class:`PackMember` s)
        was built from."""
        return frozenset((n, c.generation, c.key)
                         for n, c in members.items())

    @property
    def hbm_bytes(self) -> int:
        return int(self.packed.nbytes)

    def predict_mixed(self, parts, record: bool = True):
        """parts: list of ``(model_name, X [n_i, >= width_i], raw_score)``.
        Returns one output per part, each what the member cache's
        ``predict`` returns for those rows — but the whole mixed batch
        pays ONE launch per padded bucket instead of one per model."""
        Xs, rms, ns = [], [], []
        for name, X, _raw in parts:
            X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
            if X.ndim != 2:
                raise ValueError(
                    f"serve predict expects 2-D rows, got {X.shape}")
            if X.shape[1] > self.width:
                X = X[:, :self.width]
            elif X.shape[1] < self.width:
                # a member never reads past its own width, so the pad value
                # is unreachable for this row's trees
                X = np.concatenate(
                    [X, np.full((X.shape[0], self.width - X.shape[1]),
                                np.nan, np.float32)], axis=1)
            Xs.append(X)
            rms.append(np.full(X.shape[0], self.packed.model_index[name],
                               np.int32))
            ns.append(X.shape[0])
        X = np.concatenate(Xs)
        rm = np.concatenate(rms)
        outs = []
        lo = 0
        for n, b in _plan(self.buckets, X.shape[0]):
            xb, rb = X[lo:lo + n], rm[lo:lo + n]
            lo += n
            if n < b:
                xb = np.concatenate(
                    [xb, np.zeros((b - n, self.width), np.float32)])
                rb = np.concatenate([rb, np.zeros(b - n, np.int32)])
            with self._warm_lock:
                hit = b in self._warm
                if not hit:
                    self._warm.add(b)
            if record and self.stats is not None:
                self.stats.record_cache(hit, bucket=b)
            if not hit and self.stats is not None:
                self.stats.record_bucket_compile(b)
            if record and self.stats is not None:   # one launch a bucket
                self.stats.record_packed_dispatch(
                    models=len(np.unique(rb[:n])), rows=n)
            # xb stays referenced until the result is on the host
            xt = torch.from_numpy(xb).to(self.device)
            outs.append(self.packed.predict(xt, rb)[:, :n])
        raw = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        res = []
        lo = 0
        for (name, _X, raw_score), n in zip(parts, ns):
            m = self.members[name]
            K = m.num_class
            part = m.finish(raw[:K, lo:lo + n], raw_score).cpu().numpy()
            lo += n
            res.append(part[0] if K == 1 else part.T)
        return res

    def warm(self) -> float:
        """Run every pack bucket once (zero rows, the first member)."""
        name = next(iter(self.members))
        t0 = time.perf_counter()
        for b in self.buckets:
            self.predict_mixed(
                [(name, np.zeros((b, self.width), np.float32), True)],
                record=False)
        return time.perf_counter() - t0
