"""Serving metrics: latency distributions, throughput, cache accounting.

A copy of ``lambdagap_tpu/serve/stats.py`` (the port imports nothing of
the JAX package), with the same ``snapshot`` schema (docs/serving.md), so
a dashboard reads either package's server the same way. All methods are
thread-safe; ``snapshot`` is cheap enough to poll.
"""
from __future__ import annotations

import json
import threading
import time
import zlib
from typing import Dict, Optional

from ..obs.reservoir import Reservoir as _Reservoir


class ServeStats:
    """Thread-safe serving counters + latency reservoirs.

    Times are recorded in seconds and reported in milliseconds. Schema of
    :meth:`snapshot` is documented in docs/serving.md and is the JSON the
    ``task=serve`` CLI and ``bench_serve.py`` emit.
    """

    def __init__(self, max_samples: int = 100_000) -> None:
        self._lock = threading.Lock()
        self.t_start = time.perf_counter()
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_batch_rows = 0
        self.n_dispatch_rows = 0
        self.dispatch_device_s = 0.0
        self.n_errors = 0
        self.n_timeouts = 0
        self.n_rejected = 0
        self.n_swap_failures = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.per_bucket: Dict[int, Dict[str, int]] = {}
        self.forest_builds = 0
        self.bucket_compiles = 0
        self.compiles_local = 0
        self.compiles_shared = 0
        self.packed_dispatches = 0
        self.swaps = 0
        self.evictions = 0
        self.readmissions = 0
        self._lat = _Reservoir(max_samples, seed=1)
        self._queue_wait = _Reservoir(max_samples, seed=2)
        self._device = _Reservoir(max_samples, seed=3)
        # per-model / per-tenant breakdowns (docs/serving.md): bounded
        # reservoirs per key so a many-tenant deployment stays O(keys)
        self._models: Dict[str, Dict] = {}
        self._tenants: Dict[str, Dict] = {}

    def _group(self, table: Dict[str, Dict], key: str) -> Dict:
        g = table.get(key)
        if g is None:
            g = table[key] = {"requests": 0, "rows": 0, "shed": 0,
                              "rejected": 0, "evictions": 0,
                              "readmissions": 0,
                              "lat": _Reservoir(
                                  4096,
                                  seed=zlib.crc32(key.encode()) & 0xffff)}
        return g

    # -- recording ------------------------------------------------------
    def record_request(self, queue_wait: float, device: float, total: float,
                       rows: int = 1, model: Optional[str] = None,
                       tenant: Optional[str] = None) -> None:
        with self._lock:
            self.n_requests += 1
            self.n_rows += rows
            self._lat.add(total)
            self._queue_wait.add(queue_wait)
            self._device.add(device)
            for table, key in ((self._models, model),
                               (self._tenants, tenant)):
                if key is not None:
                    g = self._group(table, key)
                    g["requests"] += 1
                    g["rows"] += rows
                    g["lat"].add(total)

    def record_batch(self, n_requests: int, rows: int) -> None:
        with self._lock:
            self.n_batches += 1
            self.n_batch_rows += rows

    def record_dispatch(self, rows: int, device_s: float) -> None:
        """One device dispatch: ``rows`` real rows in ``device_s`` seconds
        of wall-clock. Unlike the per-request reservoirs (whose rows share
        the batch's device time), this sums exactly once per dispatch, so
        ``device_us_per_row`` in the snapshot is the true per-row cost of
        the active traversal engine — the number the predict-roofline
        benches compare against the naive and native baselines."""
        with self._lock:
            self.n_dispatch_rows += rows
            self.dispatch_device_s += device_s

    def record_error(self) -> None:
        with self._lock:
            self.n_errors += 1

    def record_timeout(self, model: Optional[str] = None,
                       tenant: Optional[str] = None) -> None:
        """A request shed before dispatch (deadline expired in queue)."""
        with self._lock:
            self.n_timeouts += 1
            for table, key in ((self._models, model),
                               (self._tenants, tenant)):
                if key is not None:
                    self._group(table, key)["shed"] += 1

    def record_rejected(self, tenant: Optional[str] = None) -> None:
        """A submit refused by full-queue backpressure (reject policy or a
        per-tenant admission quota)."""
        with self._lock:
            self.n_rejected += 1
            if tenant is not None:
                self._group(self._tenants, tenant)["rejected"] += 1

    def record_eviction(self, model: Optional[str] = None) -> None:
        """A registry forest evicted under the HBM budget (its compiled
        executables freed; the host-side model is retained)."""
        with self._lock:
            self.evictions += 1
            if model is not None:
                self._group(self._models, model)["evictions"] += 1

    def record_readmission(self, model: Optional[str] = None) -> None:
        """An evicted model recompiled on first use after eviction."""
        with self._lock:
            self.readmissions += 1
            if model is not None:
                self._group(self._models, model)["readmissions"] += 1

    def record_swap_failure(self) -> None:
        """A hot-swap that failed to build/compile; the previous
        generation kept serving (rollback)."""
        with self._lock:
            self.n_swap_failures += 1

    def record_cache(self, hit: bool, bucket: Optional[int] = None) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
            if bucket is not None:
                b = self.per_bucket.setdefault(int(bucket),
                                               {"hits": 0, "misses": 0})
                b["hits" if hit else "misses"] += 1

    def record_forest_build(self) -> None:
        with self._lock:
            self.forest_builds += 1

    def record_bucket_compile(self, bucket: int) -> None:
        with self._lock:
            self.bucket_compiles += 1

    def record_compile_local(self) -> None:
        """A forest lowered by the infer compiler ON this replica (no
        fleet peer had shipped the artifact first)."""
        with self._lock:
            self.compiles_local += 1

    def record_compile_shared(self) -> None:
        """A compiled-forest build satisfied from the artifact store — a
        peer's sha256-addressed compile admitted instead of re-lowering
        (the fleet-wide one-compile contract, docs/serving.md)."""
        with self._lock:
            self.compiles_shared += 1

    def record_packed_dispatch(self, models: int, rows: int) -> None:
        """One cross-model pack dispatch covering ``models`` tenants'
        rows in a single executable (serve_pack_models)."""
        del models, rows
        with self._lock:
            self.packed_dispatches += 1

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1

    # -- reporting ------------------------------------------------------
    @staticmethod
    def _ms(d: Dict[str, float]) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in d.items()}

    @staticmethod
    def _group_block(table: Dict[str, Dict],
                     reservoirs: bool = False) -> Dict[str, Dict]:
        out = {}
        for key, g in sorted(table.items()):
            out[key] = {
                "requests": g["requests"], "rows": g["rows"],
                "shed": g["shed"], "rejected": g["rejected"],
                "evictions": g["evictions"],
                "readmissions": g["readmissions"],
                "latency_ms": {k: v * 1e3
                               for k, v in g["lat"].percentiles().items()},
            }
            if reservoirs:
                out[key]["latency_state"] = g["lat"].state(scale=1e3)
        return out

    def snapshot(self, reservoirs: bool = False) -> Dict:
        """The metrics dict of docs/serving.md. ``reservoirs=True`` adds
        the raw reservoir states (``obs.reservoir.Reservoir.state``, ms
        units, bounded) that the fleet plane merges — the lifted
        aggregate a scraper needs to sum distributions, not just
        counters."""
        with self._lock:
            elapsed = max(time.perf_counter() - self.t_start, 1e-9)
            total = self.cache_hits + self.cache_misses
            out = {
                "requests": self.n_requests,
                "rows": self.n_rows,
                "errors": self.n_errors,
                "timeouts": self.n_timeouts,
                "rejected": self.n_rejected,
                "swap_failures": self.n_swap_failures,
                "elapsed_s": elapsed,
                "throughput_rps": self.n_requests / elapsed,
                "throughput_rows_per_s": self.n_rows / elapsed,
                "latency_ms": self._ms(self._lat.percentiles()),
                "queue_wait_ms": self._ms(self._queue_wait.percentiles()),
                "device_ms": self._ms(self._device.percentiles()),
                "batches": {
                    "count": self.n_batches,
                    "mean_rows": (self.n_batch_rows / self.n_batches
                                  if self.n_batches else 0.0),
                },
                "device_us_per_row": (
                    1e6 * self.dispatch_device_s / self.n_dispatch_rows
                    if self.n_dispatch_rows else 0.0),
                "cache": {
                    "hits": self.cache_hits,
                    "misses": self.cache_misses,
                    "hit_rate": (self.cache_hits / total) if total else 0.0,
                    "forest_builds": self.forest_builds,
                    "bucket_compiles": self.bucket_compiles,
                    "compiles_local": self.compiles_local,
                    "compiles_shared": self.compiles_shared,
                    "packed_dispatches": self.packed_dispatches,
                    "per_bucket": {str(k): dict(v)
                                   for k, v in self.per_bucket.items()},
                },
                "swaps": self.swaps,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "per_model": self._group_block(self._models, reservoirs),
                "per_tenant": self._group_block(self._tenants, reservoirs),
            }
            if reservoirs:
                out["reservoirs"] = {
                    "latency_ms": self._lat.state(scale=1e3),
                    "queue_wait_ms": self._queue_wait.state(scale=1e3),
                    "device_ms": self._device.state(scale=1e3),
                }
            return out

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        return json.dumps(self.snapshot(), **kwargs)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
