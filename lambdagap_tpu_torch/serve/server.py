"""ForestServer: the serving front door.

The port of ``lambdagap_tpu/serve/server.py`` for one default model held
in one :class:`CompiledForestCache` at generation 0, behind the
:class:`MicroBatcher` and the guard degradation layer::

    server = booster.as_server()          # or ForestServer(booster)
    y = server.predict(x_row)             # blocking, batched under the hood
    fut = server.submit(rows)             # async: Future[ServeResult]
    print(server.stats_json())
    server.close()

Every response is a :class:`ServeResult` carrying the generation that
produced it. The registry and hot swap, model packing, tracing spans,
profile windows, fault plans, the frontend, the router and the fleet wait
for later slices.
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..guard.degrade import HealthMonitor
from .batcher import MicroBatcher, Request
from .cache import DEFAULT_BUCKETS, CompiledForestCache
from .stats import ServeStats

DEFAULT_MODEL = "default"


class ServeResult(NamedTuple):
    """One request's predictions + the model generation that served it."""
    values: np.ndarray
    generation: int


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """``"tenant:weight,tenant2:weight2"`` -> dict (unlisted tenants weigh
    1.0 in the fair queue)."""
    out: Dict[str, float] = {}
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if ":" not in tok:
            raise ValueError(f"serve_tenant_weights token {tok!r} is not "
                             "'tenant:weight'")
        name, w = tok.rsplit(":", 1)
        out[name.strip()] = float(w)
    return out


class ForestServer:
    """Batched inference server for one model on the booster's device.

    Accepts a ``basic.Booster`` or a ``models.gbdt.GBDT``. Defaults for the
    batching/bucket knobs come from the booster's config (``serve_*``
    parameters); keyword arguments override.
    """

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 workers: Optional[int] = None,
                 warmup: Optional[bool] = None,
                 raw_score: bool = False,
                 start_iteration: int = 0, num_iteration: int = -1,
                 stats: Optional[ServeStats] = None,
                 max_queue: Optional[int] = None,
                 backpressure: Optional[str] = None,
                 timeout_ms: Optional[float] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_max_share: Optional[float] = None) -> None:
        gbdt = model._booster if hasattr(model, "_booster") else model
        cfg = gbdt.config
        self.raw_score = bool(raw_score)
        self._buckets = tuple(buckets if buckets is not None
                              else (cfg.serve_buckets or DEFAULT_BUCKETS))
        self.stats = stats if stats is not None else ServeStats()
        self._closed = False
        self._cache = CompiledForestCache(
            gbdt, buckets=self._buckets, start_iteration=start_iteration,
            num_iteration=num_iteration, generation=0, stats=self.stats)
        if bool(cfg.serve_warmup if warmup is None else warmup):
            self._cache.warm()
        self.health = HealthMonitor()
        nw = int(cfg.serve_workers if workers is None else workers)
        if nw <= 0:                      # auto: overlap dispatches, bounded
            nw = max(1, min(4, (os.cpu_count() or 1) // 2))
        if tenant_weights is None:
            tenant_weights = parse_tenant_weights(cfg.serve_tenant_weights)
        self._batcher = MicroBatcher(
            self._run_batch,
            max_batch=int(cfg.serve_max_batch if max_batch is None
                          else max_batch),
            max_delay_ms=float(cfg.serve_max_delay_ms if max_delay_ms is None
                               else max_delay_ms),
            workers=nw,
            stats=self.stats,
            max_queue=int(cfg.serve_max_queue if max_queue is None
                          else max_queue),
            backpressure=(cfg.serve_backpressure if backpressure is None
                          else backpressure),
            timeout_ms=float(cfg.serve_timeout_ms if timeout_ms is None
                             else timeout_ms),
            health=self.health,
            tenant_weights=tenant_weights,
            tenant_max_share=float(cfg.serve_tenant_max_share
                                   if tenant_max_share is None
                                   else tenant_max_share))

    @property
    def cache(self) -> CompiledForestCache:
        return self._cache

    # -- request path ---------------------------------------------------
    def submit(self, x, tenant: Optional[str] = None
               ) -> "Future[ServeResult]":
        """Async predict: enqueue rows, return a Future of
        :class:`ServeResult`. ``x`` is one row [D] or a matrix [n, D];
        ``tenant`` bills the request to a fairness/accounting lane."""
        if self._closed:
            raise RuntimeError("ForestServer is closed")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"serve requests are rows [n, D], got {x.shape}")
        return self._batcher.submit(x, tenant=tenant)

    def predict(self, x, timeout: Optional[float] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Blocking predict with ``Booster.predict`` output semantics:
        [n] for single-class models, [n, K] for multiclass."""
        return self.submit(x, tenant=tenant).result(timeout).values

    # -- metrics / lifecycle -------------------------------------------
    def stats_snapshot(self) -> dict:
        """The serving metrics dict (the JAX package's schema, without the
        registry block)."""
        snap = self.stats.snapshot()
        snap["generation"] = self._cache.generation
        snap["buckets"] = list(self._cache.buckets)
        snap["engine"] = self._cache.engine
        snap["device"] = str(self._cache.device)
        snap["health"] = self.health.snapshot()
        return snap

    def stats_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        return json.dumps(self.stats_snapshot(), **kwargs)

    def close(self, timeout: float = 30.0) -> None:
        """Flush queued requests and stop the batcher threads. Health
        reports DRAINING from the first close() call onward."""
        if not self._closed:
            self._closed = True
            self.health.set_draining()
            self._batcher.close(timeout)

    def __enter__(self) -> "ForestServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _gather_rows(self, reqs: List[Request]) -> tuple:
        """Shape-check requests against the compiled width: returns
        (rows, good requests); violators fail their own future."""
        W = self._cache.width
        disable_check = self._cache.gbdt.config.predict_disable_shape_check
        rows: List[np.ndarray] = []
        good: List[Request] = []
        for r in reqs:
            x = r.x
            if x.shape[1] < W:
                if not disable_check:
                    r.future.set_exception(ValueError(
                        f"request has {x.shape[1]} features but the model "
                        f"needs {W}; set predict_disable_shape_check=true "
                        "to pad missing features with NaN"))
                    self.stats.record_error()
                    continue
                x = np.concatenate(
                    [x, np.full((x.shape[0], W - x.shape[1]), np.nan,
                                np.float32)], axis=1)
            rows.append(np.ascontiguousarray(x[:, :W]))
            good.append(r)
        return rows, good

    def _run_batch(self, batch: List[Request]) -> None:
        """Worker-thread batch execution: the coalesced batch through one
        padded dispatch plan, results scattered back to the futures (the
        JAX package's ``_dispatch_group`` for its one model)."""
        t0 = time.perf_counter()
        rows, good = self._gather_rows(batch)
        if not good:
            return
        X = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)
        out = self._cache.predict(X, raw_score=self.raw_score)
        t1 = time.perf_counter()
        self.stats.record_dispatch(rows=X.shape[0], device_s=t1 - t0)
        lo = 0
        for r, x in zip(good, rows):
            n = x.shape[0]
            r.future.set_result(ServeResult(out[lo:lo + n],
                                            self._cache.generation))
            lo += n
            self.stats.record_request(queue_wait=t0 - r.t_submit,
                                      device=t1 - t0,
                                      total=time.perf_counter() - r.t_submit,
                                      rows=n, model=DEFAULT_MODEL,
                                      tenant=r.tenant)
