"""Multi-model registry: N compiled forests resident under a device
memory budget.

The port of ``lambdagap_tpu/serve/registry.py``. The registry owns every
compiled forest, its padding buckets, its generation pointer and its
hot-swap; the server keeps only policy (batching, shedding, health).

Residency is governed by an explicit byte budget (``serve_hbm_budget_mb``):
each compiled forest charges its device footprint
(:attr:`CompiledForestCache.hbm_bytes`: on the compiled engine the
artifact's tables plus the kernel's 16-byte records and tree CSR), and
admitting a forest past the budget evicts least-recently-used models
first. Eviction frees the device forest but RETAINS the host-side model
and the generation pointer, so a later request re-admits it with exactly
one rebuild and an unchanged generation — evictions and re-admissions are
counted in :class:`~lambdagap_tpu_torch.serve.stats.ServeStats`.

Lock discipline: the registry lock guards only the name map, LRU metadata
and pointer flips — forest loads, compiles and uploads happen OUTSIDE it.
Concurrent first uses of an evicted model single-flight through a
per-entry pending event (waiters park on the event, not on a lock held
across the build); concurrent swaps of one model serialize on that
entry's :class:`~lambdagap_tpu_torch.serve.swap.SwapController`.

Generation semantics are per model: every model's generations count up
from 0 independently, every response carries the generation that produced
it, and a swap pre-warms before the pointer flip — in-flight batches
finish on the forest they started with.

Device: every forest lives on the registry's device (the server's); a
swap source that would land elsewhere fails the swap (``SwapFailed``) and
is never moved silently (``serve/swap.load_booster``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..guard.degrade import CircuitBreaker
from ..utils import log
from .swap import SwapController, load_booster

DEFAULT_MODEL = "default"


class ModelEntry:
    """One registered model: host booster + (maybe) its compiled forest.

    ``cache`` is the residency pointer — ``None`` means evicted. It is
    read lock-free by the dispatch path (an atomic reference under the
    GIL); all writes happen under the registry lock. ``swapper`` runs this
    model's hot-swaps (:class:`~lambdagap_tpu_torch.serve.swap.
    SwapController`, publishing through the registry's admission) and
    holds its circuit ``breaker``.
    """

    __slots__ = ("name", "gbdt", "generation", "cache", "bytes", "width",
                 "engine", "buckets", "builds", "last_used", "swapper",
                 "pending")

    def __init__(self, name: str) -> None:
        self.name = name
        self.gbdt = None
        self.generation = -1             # no generation admitted yet
        self.cache = None                # CompiledForestCache or None
        self.bytes = 0
        self.width = 1
        self.engine = "compiled"
        self.buckets: tuple = ()
        self.builds = 0                  # compiles: install + swaps + readmits
        self.last_used = 0
        self.swapper: Optional[SwapController] = None
        self.pending: Optional[threading.Event] = None   # single-flight

    @property
    def breaker(self) -> CircuitBreaker:
        return self.swapper.breaker

    @property
    def resident(self) -> bool:
        return self.cache is not None


class ModelRegistry:
    """Name -> :class:`ModelEntry` map with LRU eviction under a byte
    budget.

    ``build_cache(gbdt, generation) -> CompiledForestCache`` is supplied
    by the server (it closes over the bucket/engine/warmup policy); the
    registry decides *when* to call it — install, swap, re-admission —
    and what to evict to make the result fit. ``device``: where every
    forest must live (None: wherever its source loads). ``clock``: the
    swap breakers' clock (injectable for tests).
    """

    def __init__(self, build_cache: Callable, stats=None,
                 hbm_budget_bytes: int = 0,
                 breaker_threshold: int = 3,
                 artifact_store=None,
                 device: Optional[torch.device] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._build = build_cache
        self._stats = stats
        self.device = device
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        self._breaker_threshold = int(breaker_threshold)
        self._clock = clock
        # shared infer.ArtifactStore (compiled engine): builds consult it
        # by source key before compiling, and admit_artifact() feeds it
        # peer-shipped compiles so replicas pay for ONE lowering
        self.artifacts = artifact_store
        self._lock = threading.Lock()    # name map + LRU metadata + flips
        self._entries: Dict[str, ModelEntry] = {}
        self._seq = itertools.count(1)

    # -- introspection --------------------------------------------------
    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def entry(self, name: str) -> ModelEntry:
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise KeyError(f"unknown serve model {name!r} "
                           f"(registered: {self.names() or 'none'})")
        return e

    def generation(self, name: str = DEFAULT_MODEL) -> int:
        return self.entry(name).generation

    # -- admission ------------------------------------------------------
    def install(self, name: str, source, params=None) -> int:
        """Register a new model under ``name`` and compile it (generation
        0). Duplicate names are an error — use :meth:`swap` to replace a
        registered model's forest."""
        e = ModelEntry(name)
        e.swapper = SwapController(
            self._build, stats=self._stats,
            breaker=CircuitBreaker(threshold=self._breaker_threshold,
                                   clock=self._clock),
            device=self.device, name=name,
            generation=lambda: e.generation,
            publish=lambda gbdt, cache: self._admit(e, gbdt, cache))
        with self._lock:
            if name in self._entries:
                raise ValueError(f"serve model {name!r} is already "
                                 "registered; swap() replaces it")
            self._entries[name] = e
            # a get() racing the install parks on this event instead of
            # finding a half-built entry
            e.pending = threading.Event()
        try:
            gbdt = load_booster(source, params, self.device)
            cache = self._build(gbdt, 0)
            self._admit(e, gbdt, cache)
        except Exception:
            with self._lock:             # failed install leaves no entry
                self._entries.pop(name, None)
            raise
        finally:
            with self._lock:
                ev, e.pending = e.pending, None
            ev.set()
        log.info("serve registry: installed model %r (%d bytes resident, "
                 "%d models registered)", name, e.bytes, len(self._entries))
        return 0

    def get(self, name: str = DEFAULT_MODEL,
            info: Optional[Dict] = None):
        """The resident compiled forest for ``name`` — touching LRU, and
        re-admitting (ONE recompile, generation preserved) if the model
        was evicted. Concurrent callers of an evicted model single-flight
        the rebuild; the losers park on an event, never on a lock held
        across the compile.

        ``info`` (optional dict) is filled with what the resolve cost:
        ``readmitted=True`` + ``build_s`` when THIS call paid the
        recompile, ``waited=True`` when it parked behind another caller's
        rebuild — the per-request visibility of the readmission cliff."""
        while True:
            with self._lock:
                e = self._entries.get(name)
                if e is None:
                    raise KeyError(f"unknown serve model {name!r} "
                                   f"(registered: "
                                   f"{sorted(self._entries) or 'none'})")
                e.last_used = next(self._seq)
                cache = e.cache
                if cache is not None:
                    return cache
                if e.pending is None:
                    e.pending = threading.Event()
                    waiter = None
                else:
                    waiter = e.pending
                gbdt, gen = e.gbdt, e.generation
            if waiter is not None:
                if info is not None:
                    info["waited"] = True
                waiter.wait(60.0)
                continue
            try:
                t0 = time.perf_counter()
                cache = self._build(gbdt, gen)   # outside every lock
                if info is not None:
                    info["readmitted"] = True
                    info["build_s"] = time.perf_counter() - t0
                    ah = cache.artifact_hash
                    if ah:                       # compiled engine: which
                        info["artifact_hash"] = ah  # artifact was rebuilt
                admitted = self._admit(e, gbdt, cache, readmission=True,
                                       expect_generation=gen)
            finally:
                with self._lock:
                    ev, e.pending = e.pending, None
                ev.set()
            if not admitted:
                # a concurrent swap published a newer generation while we
                # rebuilt the old one: drop the stale build and re-resolve
                continue
            log.info("serve registry: re-admitted evicted model %r "
                     "(generation %d preserved, %d bytes)", name,
                     e.generation, e.bytes)
            return cache

    def swap(self, name: str, source, params=None,
             background: bool = False):
        """Replace model ``name``'s forest (path / model text / Booster /
        GBDT) through its :class:`SwapController`: load + compile +
        pre-warm OFF the serving path, then admit (flip the entry's
        residency pointer). A failed load/compile raises
        :class:`SwapFailed` without touching the old forest and feeds this
        model's circuit breaker; an open circuit rejects up front with
        :class:`SwapRejected`. Works on evicted entries too — the swap
        admits the NEW forest, so the old one is never recompiled just to
        be replaced."""
        return self.entry(name).swapper.swap(source, params,
                                             background=background)

    def swap_delta(self, name: str, delta):
        """Delta hot-swap (serve/delta.py): reconstruct the new model
        text from this entry's RESIDENT host model + the appended-trees
        frame, then take the normal :meth:`swap` path. A delta that does
        not apply (stale base, wrong hash, torn frame) raises
        :class:`SwapFailed` through the same breaker-fed rollback: the
        active generation keeps serving."""
        from .delta import model_text_of
        e = self.entry(name)
        return e.swapper.swap_delta(model_text_of(e.gbdt), delta)

    def admit_artifact(self, payload: bytes,
                       expect_hash: Optional[str] = None) -> str:
        """Admit a peer-shipped compiled-forest artifact into this
        replica's :class:`~lambdagap_tpu_torch.infer.ArtifactStore`
        (content hash verified BEFORE the store mutates — a torn or
        tampered frame raises ``ArtifactMismatch`` and the next build
        compiles locally, never serving the wrong model). Returns the
        verified hash; later builds whose source key matches skip the
        compiler (``compiles_shared``)."""
        if self.artifacts is None:
            from ..infer import ArtifactStore
            self.artifacts = ArtifactStore()
        art = self.artifacts.admit_bytes(payload, expect_hash=expect_hash)
        log.info("serve registry: admitted compiled artifact %s "
                 "(%d trees, %d bytes) by hash — local compile skipped on "
                 "next matching build", art.hash[:12], art.num_trees,
                 art.nbytes)
        return art.hash

    def artifact_bytes(self, name: str = DEFAULT_MODEL) -> bytes:
        """Serialized compiled artifact of model ``name`` — what a
        publisher ships to peers so N replicas share ONE compile. Requires
        the compiled engine (the artifact is attached at cache build
        time)."""
        cache = self.get(name)
        art = cache.artifact
        if art is None:
            raise ValueError(
                f"serve model {name!r} has no compiled artifact (engine "
                f"{cache.engine!r}; artifact sharing needs "
                f"predict_engine=compiled)")
        return art.to_bytes()

    def model_text(self, name: str = DEFAULT_MODEL) -> str:
        """The resident host model's full text — the base a delta
        publisher diffs against (host models survive eviction, so this
        never recompiles anything)."""
        from .delta import model_text_of
        return model_text_of(self.entry(name).gbdt)

    def remove(self, name: str) -> None:
        """Forget a model entirely (device AND host side). In-flight
        batches that already hold its compiled forest finish normally."""
        with self._lock:
            e = self._entries.pop(name, None)
        if e is None:
            raise KeyError(f"unknown serve model {name!r}")
        log.info("serve registry: removed model %r", name)

    # -- residency ------------------------------------------------------
    def _admit(self, e: ModelEntry, gbdt, cache, readmission: bool = False,
               expect_generation: Optional[int] = None) -> bool:
        """Flip ``e`` to the freshly built ``cache``, evicting LRU models
        first when the budget demands it. The build already happened —
        admission is pointer work under the registry lock. With
        ``expect_generation`` set (re-admission), the flip is abandoned if
        a concurrent swap already published a newer generation — a stale
        rebuild must never roll a model back."""
        need = cache.hbm_bytes
        evicted: List[str] = []
        with self._lock:
            if (expect_generation is not None
                    and e.generation != expect_generation):
                return False
            if self.hbm_budget_bytes > 0:
                resident = sorted(
                    (o for o in self._entries.values()
                     if o is not e and o.cache is not None),
                    key=lambda o: o.last_used)
                used = sum(o.bytes for o in resident) + (
                    e.bytes if e.cache is not None else 0)
                for victim in resident:
                    if used + need <= self.hbm_budget_bytes:
                        break
                    victim.cache = None          # atomic un-publish
                    used -= victim.bytes
                    evicted.append(victim.name)
                if used + need > self.hbm_budget_bytes:
                    log.warning(
                        "serve registry: model %r alone (%d bytes) exceeds "
                        "serve_hbm_budget_mb (%d bytes); admitting anyway "
                        "— the budget bounds the fleet, one model is the "
                        "floor", e.name, need, self.hbm_budget_bytes)
            e.gbdt = gbdt
            e.generation = cache.generation
            e.cache = cache
            e.bytes = need
            e.width = cache.width
            e.engine = cache.engine
            e.buckets = tuple(cache.buckets)
            e.builds += 1
            e.last_used = next(self._seq)
        for name in evicted:
            if self._stats is not None:
                self._stats.record_eviction(model=name)
            log.info("serve registry: evicted model %r under the HBM "
                     "budget (host model retained; next use recompiles)",
                     name)
        if readmission and self._stats is not None:
            self._stats.record_readmission(model=e.name)
        return True

    # -- reporting ------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            models = {}
            resident_bytes = 0
            for name, e in sorted(self._entries.items()):
                models[name] = {
                    "resident": e.cache is not None,
                    "generation": e.generation,
                    "hbm_bytes": e.bytes if e.cache is not None else 0,
                    "builds": e.builds,
                    "width": e.width,
                    "engine": e.engine,
                }
                if e.cache is not None:
                    resident_bytes += e.bytes
                    ah = e.cache.artifact_hash
                    if ah:
                        models[name]["artifact_hash"] = ah
            return {
                "models": models,
                "resident_models": sum(1 for m in models.values()
                                       if m["resident"]),
                "registered_models": len(models),
                "hbm_bytes_resident": resident_bytes,
                "hbm_budget_bytes": self.hbm_budget_bytes,
            }
