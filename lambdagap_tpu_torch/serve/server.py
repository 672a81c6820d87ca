"""ForestServer: the serving front door.

The port of ``lambdagap_tpu/serve/server.py``. Composes the serving pieces
— :class:`ModelRegistry` (N compiled forests under a device memory budget,
per-model generations + hot swap), :class:`MicroBatcher` (request
coalescing with weighted tenant fairness) and the guard degradation layer
— behind a two-call API::

    server = booster.as_server()          # or ForestServer(booster)
    y = server.predict(x_row)             # blocking, batched under the hood
    fut = server.submit(rows)             # async: Future[ServeResult]
    server.add_model("b", "model_b.txt")  # multi-model registry
    y_b = server.predict(x_row, model="b")
    server.swap("model_v2.txt")           # zero-downtime model replace
    print(server.stats_json())
    server.close()

Every response is a :class:`ServeResult` carrying the generation that
produced it: under a concurrent stream with swaps, each result matches
exactly one generation's forest. Every model lives on the server's device
(the initial booster's). Under ``serve_pack_models`` a mixed batch of
several models is one launch of the fused kernel's packed mode per padded
bucket (:class:`~lambdagap_tpu_torch.serve.cache.ModelPack`): every
registered model must then pack (compiled engine, no prediction early
stop), and all of them stay resident, so the knob refuses a
``serve_hbm_budget_mb``.

Tracing spans, profile windows, fault plans, ``predict_stream``, the
frontend, the router, placement, autonomics, shadow traffic and the
``task=serve`` loop wait for later slices.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..guard.degrade import HealthMonitor
from ..utils import log
from .batcher import MicroBatcher, Request
from .cache import DEFAULT_BUCKETS, CompiledForestCache, ModelPack
from .registry import DEFAULT_MODEL, ModelRegistry
from .stats import ServeStats


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
    """Batched, hot-swappable, multi-model inference server on the initial
    booster's device.

    Accepts a ``basic.Booster`` or a ``models.gbdt.GBDT`` as the initial
    (``"default"``) model. Defaults for the batching/bucket/registry knobs
    come from the booster's config (``serve_*`` parameters); keyword
    arguments override.
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
                 swap_breaker: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_max_share: Optional[float] = None) -> None:
        gbdt = model._booster if hasattr(model, "_booster") else model
        cfg = gbdt.config
        self.raw_score = bool(raw_score)
        self.device = torch.device(gbdt.device)
        self._buckets = tuple(buckets if buckets is not None
                              else (cfg.serve_buckets or DEFAULT_BUCKETS))
        self._warmup = bool(cfg.serve_warmup if warmup is None else warmup)
        self._si = int(start_iteration)
        self._ni = int(num_iteration)
        self.stats = stats if stats is not None else ServeStats()
        self._closed = False
        if hbm_budget_bytes is None:
            hbm_budget_bytes = int(cfg.serve_hbm_budget_mb * (1 << 20))
        # cross-model packing (serve_pack_models): every registered model
        # merges into ONE packed forest so a mixed batch launches once per
        # bucket; rebuilt on a membership or generation change
        self._pack_models = bool(cfg.serve_pack_models)
        if self._pack_models and hbm_budget_bytes > 0:
            raise ValueError(
                "serve_pack_models serves every registered model from one "
                "packed forest, so every model and the pack stay resident; "
                "serve_hbm_budget_mb would have to evict a model the pack "
                "needs. Set one or the other")
        self._pack: Optional[ModelPack] = None
        self._pack_lock = threading.Lock()
        # the server-wide compiled-artifact store: builds consult it by
        # source key before compiling (admit_artifact feeds it peers'
        # artifacts), so replicas placing one model pay ONE compile
        from ..infer import ArtifactStore
        self.artifacts = ArtifactStore()
        self.registry = ModelRegistry(
            self._build_cache, stats=self.stats,
            hbm_budget_bytes=hbm_budget_bytes,
            breaker_threshold=int(cfg.serve_swap_breaker
                                  if swap_breaker is None else swap_breaker),
            artifact_store=self.artifacts, device=self.device)
        self.registry.install(DEFAULT_MODEL, gbdt)
        self.health = HealthMonitor(
            breaker=self.registry.entry(DEFAULT_MODEL).breaker)
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

    # ------------------------------------------------------------------
    def _build_cache(self, gbdt, generation: int) -> CompiledForestCache:
        cache = CompiledForestCache(
            gbdt, buckets=self._buckets, start_iteration=self._si,
            num_iteration=self._ni, generation=generation, stats=self.stats,
            artifact_store=self.artifacts)
        if self._pack_models and (cache._compiled is None or cache._es_freq):
            # refused at install / swap, never found at request time
            raise ValueError(
                "serve_pack_models needs every model on predict_engine="
                "compiled with a nonempty tree slice and no prediction "
                f"early stop; this one has engine {cache.engine!r}, "
                f"{len(cache.idx)} trees, pred_early_stop_freq "
                f"{cache._es_freq}")
        if self._warmup:
            cache.warm()
        if cache.device.type == "cuda":
            # a background swap builds on its own thread: its uploads and
            # warm launches are done before the registry flips the pointer
            torch.cuda.synchronize(cache.device)
        return cache

    @property
    def generation(self) -> int:
        return self.registry.generation(DEFAULT_MODEL)

    @property
    def num_features(self) -> int:
        """Width the default model's compiled forest consumes (1 + max
        split feature); narrower requests error unless
        predict_disable_shape_check pads them with NaN."""
        return self.registry.entry(DEFAULT_MODEL).width

    @property
    def cache(self) -> CompiledForestCache:
        """The default model's resident forest (re-admitted if evicted)."""
        return self.registry.get(DEFAULT_MODEL)

    # -- model management ----------------------------------------------
    def add_model(self, name: str, source, params=None) -> int:
        """Register an additional model (path, model text, Booster or
        GBDT) under ``name``; it compiles (and warms) now, off the request
        path, on the server's device, subject to the registry's budget.
        Under ``serve_pack_models`` a model that cannot pack raises
        ValueError."""
        return self.registry.install(name, source, params=params)

    def models(self) -> List[str]:
        return self.registry.names()

    def admit_artifact(self, payload: bytes,
                       expect_hash: Optional[str] = None) -> str:
        """Admit a peer's serialized compiled-forest artifact by content
        hash. The next compiled-engine build whose source key matches
        serves the admitted artifact instead of compiling — a mismatched
        or torn payload raises ``ArtifactMismatch`` and the build compiles
        locally instead, never serving the wrong model. Returns the
        verified hash."""
        return self.registry.admit_artifact(payload, expect_hash=expect_hash)

    def artifact_bytes(self, model: str = DEFAULT_MODEL) -> bytes:
        """Serialize ``model``'s compiled artifact for shipping to peers
        (requires predict_engine=compiled)."""
        return self.registry.artifact_bytes(model)

    # -- request path ---------------------------------------------------
    def submit(self, x, model: Optional[str] = None,
               tenant: Optional[str] = None) -> "Future[ServeResult]":
        """Async predict: enqueue rows, return a Future of
        :class:`ServeResult`. ``x`` is one row [D] or a matrix [n, D];
        ``model`` routes to a registry model (default: the initial one);
        ``tenant`` bills the request to a fairness/accounting lane."""
        if self._closed:
            raise RuntimeError("ForestServer is closed")
        name = model if model is not None else DEFAULT_MODEL
        if not self.registry.has(name):
            raise ValueError(f"unknown serve model {name!r} "
                             f"(registered: {self.models()})")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"serve requests are rows [n, D], got {x.shape}")
        return self._batcher.submit(x, model=name, tenant=tenant)

    def predict(self, x, timeout: Optional[float] = None,
                model: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Blocking predict with ``Booster.predict`` output semantics:
        [n] for single-class models, [n, K] for multiclass."""
        return self.submit(x, model=model, tenant=tenant).result(
            timeout).values

    # -- hot swap -------------------------------------------------------
    def swap(self, source, params=None, background: bool = False,
             model: str = DEFAULT_MODEL):
        """Atomically replace a served model (path, model text, Booster
        or GBDT). The new forest is compiled and pre-warmed BEFORE the
        generation pointer flips; in-flight requests finish on the old
        forest. Returns the new generation (or the worker thread when
        ``background=True``). Under ``serve_pack_models`` the swap also
        rebuilds the pack before it returns (the next batch pays no build,
        and the swapped-out forest's tables are freed), and a model that
        cannot pack fails the swap (``SwapFailed`` from ValueError)."""
        if background:
            t = threading.Thread(target=self.swap,
                                 args=(source, params, False, model),
                                 daemon=True,
                                 name=f"lambdagap-serve-swap-{model}")
            t.start()
            return t
        gen = self.registry.swap(model, source, params=params)
        self._refresh_pack()
        return gen

    def swap_delta(self, delta, model: str = DEFAULT_MODEL) -> int:
        """Delta hot-swap: apply an appended-trees frame
        (serve/delta.py) against the resident host model, then compile /
        pre-warm / flip exactly like :meth:`swap`. Returns the new
        generation; a non-applying delta raises ``SwapFailed`` with the
        old generation untouched."""
        gen = self.registry.swap_delta(model, delta)
        self._refresh_pack()
        return gen

    def model_text(self, model: str = DEFAULT_MODEL) -> str:
        """The resident host model's full text (delta-swap base)."""
        return self.registry.model_text(model)

    def prefetch(self, model: str = DEFAULT_MODEL) -> Dict:
        """Make ``model`` resident NOW (re-admitting it if evicted) and
        report what that cost, so the readmission cliff is paid off the
        request path."""
        info: Dict = {}
        self.registry.get(model, info=info)
        info.setdefault("readmitted", False)
        info["resident"] = True
        return info

    # -- metrics / lifecycle -------------------------------------------
    def stats_snapshot(self) -> dict:
        """The serving metrics dict (the JAX package's schema, with the
        server's device)."""
        entry = self.registry.entry(DEFAULT_MODEL)
        snap = self.stats.snapshot()
        snap["generation"] = entry.generation
        snap["buckets"] = list(entry.buckets)
        snap["engine"] = entry.engine
        snap["device"] = str(self.device)
        snap["health"] = self.health.snapshot()
        snap["registry"] = self.registry.snapshot()
        pack = self._pack
        snap["registry"]["pack_hbm_bytes"] = (pack.hbm_bytes if pack
                                              is not None else 0)
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
    def _run_batch(self, batch: List[Request]) -> None:
        """Worker-thread batch execution: group the coalesced batch by
        registry model, snapshot each model's compiled forest once, run
        ONE padded dispatch per model (or, packed, one for all), scatter
        results back to futures. A model that fails to resolve (removed,
        or its re-admission build failed) fails only ITS requests; the
        other groups still serve. Under packing, a failed resolve of any
        member fails the batch (the batcher fans the error out)."""
        groups: Dict[str, List[Request]] = {}
        for r in batch:
            groups.setdefault(r.model or DEFAULT_MODEL, []).append(r)
        if self._pack_models:
            self._dispatch_packed(self._model_pack(), groups)
            return
        for name, reqs in sorted(groups.items()):
            try:
                slot = self.registry.get(name)     # LRU; may readmit
            except Exception as e:
                self._fail(reqs, e)
                continue
            self._dispatch_group(name, slot, reqs)

    def _fail(self, reqs: List[Request], exc: Exception) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
        self.stats.record_error()

    def _model_pack(self) -> ModelPack:
        """The cross-model pack of every registered model, each resolved
        ONCE here. A batch is served AND stamped from this pack's own
        members, so every answer carries the generation that computed it.
        Rebuilt whenever membership or a member's generation changes
        (``ModelPack.key_of``). Every member packs: ``_build_cache``
        refuses any other under ``serve_pack_models``."""
        slots: Dict[str, CompiledForestCache] = {}
        for name in self.registry.names():
            try:
                slots[name] = self.registry.get(name)
            except KeyError:             # removed since names(): its
                continue                 # requests fail in the dispatch
        key = ModelPack.key_of(slots)
        with self._pack_lock:
            pack = self._pack
            if pack is None or pack.key != key:
                pack = ModelPack(slots, buckets=self._buckets,
                                 stats=self.stats)
                if pack.device.type == "cuda":
                    # built on a swap's thread too: uploads done before use
                    torch.cuda.synchronize(pack.device)
                self._pack = pack
                log.info("serve: packed %d models into one forest (%d "
                         "trees, width %d, %d bytes)", len(slots),
                         pack.packed.num_trees, pack.width, pack.hbm_bytes)
            return pack

    def _refresh_pack(self) -> None:
        if self._pack_models:
            self._model_pack()

    def _gather_rows(self, name: str, W: int, disable_check: bool,
                     reqs: List[Request]) -> tuple:
        """Shape-check one model's requests against its compiled width
        ``W``: returns (rows, good requests); violators fail their own
        future."""
        rows: List[np.ndarray] = []
        good: List[Request] = []
        for r in reqs:
            x = r.x
            if x.shape[1] < W:
                if not disable_check:
                    r.future.set_exception(ValueError(
                        f"request has {x.shape[1]} features but model "
                        f"{name!r} needs {W}; set "
                        "predict_disable_shape_check=true to pad missing "
                        "features with NaN"))
                    self.stats.record_error()
                    continue
                x = np.concatenate(
                    [x, np.full((x.shape[0], W - x.shape[1]), np.nan,
                                np.float32)], axis=1)
            rows.append(np.ascontiguousarray(x[:, :W]))
            good.append(r)
        return rows, good

    def _scatter(self, name: str, generation: int, good: List[Request],
                 rows: List[np.ndarray], out: np.ndarray, t0: float,
                 t1: float) -> None:
        """Resolve one model's requests with their slices of ``out``,
        stamped with the generation that computed it."""
        lo = 0
        for r, x in zip(good, rows):
            n = x.shape[0]
            r.future.set_result(ServeResult(out[lo:lo + n], generation))
            lo += n
            self.stats.record_request(queue_wait=t0 - r.t_submit,
                                      device=t1 - t0,
                                      total=time.perf_counter() - r.t_submit,
                                      rows=n, model=name, tenant=r.tenant)

    def _dispatch_packed(self, pack: ModelPack,
                         groups: Dict[str, List[Request]]) -> None:
        """A mixed multi-model batch through the pack: every model's rows
        concatenate into shared padding buckets, one fused launch per
        bucket, and each request's slice comes back bit-identical to its
        member cache serving it alone, stamped with the generation of the
        pack's member."""
        t0 = time.perf_counter()
        parts: List[tuple] = []
        for name, reqs in sorted(groups.items()):
            m = pack.members.get(name)
            if m is None:
                self._fail(reqs, KeyError(f"unknown serve model {name!r}"))
                continue
            rows, good = self._gather_rows(name, m.width,
                                           m.disable_shape_check, reqs)
            if good:
                parts.append((name, m, good, rows))
        if not parts:
            return
        mixed = [(name, rows[0] if len(rows) == 1
                  else np.concatenate(rows, axis=0), self.raw_score)
                 for name, _slot, _good, rows in parts]
        outs = pack.predict_mixed(mixed)
        t1 = time.perf_counter()
        total_rows = sum(x.shape[0] for _n, x, _r in mixed)
        self.stats.record_dispatch(rows=total_rows, device_s=t1 - t0)
        for (name, m, good, rows), out in zip(parts, outs):
            self._scatter(name, m.generation, good, rows, out, t0, t1)

    def _dispatch_group(self, name: str, slot, reqs: List[Request]) -> None:
        """One model's share of a batch through one padded dispatch."""
        t0 = time.perf_counter()
        rows, good = self._gather_rows(
            name, slot.width, slot.gbdt.config.predict_disable_shape_check,
            reqs)
        if not good:
            return
        X = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)
        out = slot.predict(X, raw_score=self.raw_score)
        t1 = time.perf_counter()
        self.stats.record_dispatch(rows=X.shape[0], device_s=t1 - t0)
        self._scatter(name, slot.generation, good, rows, out, t0, t1)
