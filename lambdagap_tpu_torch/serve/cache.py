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
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

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
    """

    def __init__(self, gbdt, buckets: Optional[Sequence[int]] = None,
                 start_iteration: int = 0, num_iteration: int = -1,
                 generation: int = 0, stats=None) -> None:
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
            from ..infer import CompiledForest, compile_forest
            art = compile_forest(gbdt, start_iteration, num_iteration)
            if stats is not None:
                stats.record_compile_local()
            self.artifact = art
            self._compiled = CompiledForest(
                art, self.device, early_stop_freq=self._es_freq,
                early_stop_margin=self._es_margin)
        self._warm: set = set()
        self._warm_lock = threading.Lock()
        self.build_time_s = 0.0
        if stats is not None:
            stats.record_forest_build()

    # ------------------------------------------------------------------
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
        if self.gbdt.average_output:
            out = out / self._n_iters
        obj = self.gbdt.objective
        if not raw_score and obj is not None:
            out = obj.convert_output(out)
        return out

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
