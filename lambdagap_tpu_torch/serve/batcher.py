"""Micro-batching request queue: coalesce concurrent predicts into one
padded device dispatch.

A copy of ``lambdagap_tpu/serve/batcher.py`` (the port imports nothing of
the JAX package).

A single worker thread drains a thread-safe queue under a
max-batch/max-latency policy (the classic dynamic-batching scheduler of
TF-Serving/Triton): the first request of a batch opens a window of
``max_delay_ms``; everything arriving inside the window joins, up to
``max_batch`` rows, then the whole batch runs as ONE compiled-forest
dispatch. Batch-size-1 request streams therefore pay one device dispatch
per ~``max_batch`` requests instead of one each — the coalescing half of
serve's throughput win (the compile-once half lives in cache.py).

All device work happens on the worker thread; ``submit`` only enqueues, so
any number of client threads can call it concurrently.

Multi-tenant fairness: the queue is a
:class:`FairQueue` — per-tenant FIFO lanes drained by start-time fair
queuing (each tenant carries a virtual clock advanced by ``1/weight`` per
dequeued request), so a tenant flooding the queue cannot starve the
others: dequeue bandwidth converges to the weight ratio, not the arrival
ratio. On top of the bounded queue sits per-tenant admission control
(``max_share``): one tenant may hold at most that fraction of the queue's
capacity, and a submit beyond the quota is rejected at the door with
:class:`ServeOverloaded` naming the tenant — the hot tenant pays, not the
fleet.

Degradation contract (guard/degrade.py): the queue
is bounded by ``max_queue`` requests with a ``reject``-or-``block``
backpressure policy (reject raises :class:`ServeOverloaded` at submit
time); each request carries an optional deadline (``timeout_ms``) and is
SHED before dispatch once expired — its future resolves with
:class:`ServeTimeout` instead of wasting a device batch on a response
nobody is waiting for. Submit-after-close raises immediately, and the
submit/close race is closed by a mutex: a submit that won the race is
strictly FIFO-before the shutdown sentinels (the fair queue hands out
sentinels only once every lane is empty), so its future always resolves.
Every submitted future therefore terminates: result, error, or timeout —
never a hang.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from ..guard.degrade import ServeOverloaded, ServeTimeout


class Request:
    """One queued predict: rows + the future its caller waits on, plus the
    registry model it targets and the tenant it bills to. (The JAX
    package's Request also carries a trace context, which waits for the
    tracing slice.)"""

    __slots__ = ("x", "future", "t_submit", "deadline", "model", "tenant")

    def __init__(self, x: np.ndarray, deadline: Optional[float] = None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None) -> None:
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline         # absolute perf_counter time, or None
        self.model = model               # registry model name (None = default)
        self.tenant = tenant             # accounting/fairness key (optional)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.perf_counter())
                >= self.deadline)


_SENTINEL = object()


class Empty(Exception):
    """FairQueue.get timed out with nothing to hand out."""


class FairQueue:
    """Bounded multi-tenant queue: per-tenant FIFO lanes + weighted fair
    dequeue (start-time fair queuing) + per-tenant admission quotas.

    ``try_put`` returns ``"ok"``, ``"full"`` (global bound) or ``"quota"``
    (tenant over its ``max_share`` of capacity) instead of raising, so the
    caller owns the backpressure policy. Sentinels (worker shutdown
    markers) are handed out only once every lane is empty, which is what
    makes close() drain-safe: an accepted request is always dequeued
    before any worker sees its exit marker.
    """

    def __init__(self, maxsize: int = 0,
                 weights: Optional[Dict[str, float]] = None,
                 max_share: float = 0.0) -> None:
        self._cond = threading.Condition()
        self.maxsize = max(int(maxsize), 0)
        self._weights = {k: float(v) for k, v in (weights or {}).items()
                         if float(v) > 0}
        self.max_share = float(max_share)
        self._lanes: Dict[str, deque] = {}
        self._vt: Dict[str, float] = {}   # per-tenant virtual finish time
        self._vnow = 0.0                  # global virtual clock
        self._size = 0
        self._sentinels = 0

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def _lane_key(self, req: Request) -> str:
        return req.tenant if req.tenant is not None else ""

    def try_put(self, req: Request) -> str:
        with self._cond:
            if self.maxsize and self._size >= self.maxsize:
                return "full"
            key = self._lane_key(req)
            lane = self._lanes.get(key)
            if (self.maxsize and self.max_share > 0.0
                    and lane is not None
                    and len(lane) >= max(1, int(self.max_share
                                                * self.maxsize))):
                return "quota"
            if lane is None:
                lane = self._lanes[key] = deque()
                # a tenant joining (or re-joining after idling) starts at
                # the current virtual clock: idle time earns no backlog
                # credit against the tenants that kept the device busy
                self._vt[key] = max(self._vt.get(key, 0.0), self._vnow)
            lane.append(req)
            self._size += 1
            self._cond.notify()
            return "ok"

    def put_sentinel(self, n: int = 1) -> None:
        with self._cond:
            self._sentinels += n
            self._cond.notify_all()

    def _pop_locked(self):
        best = None
        for key, lane in self._lanes.items():
            if lane and (best is None or self._vt[key] < self._vt[best]):
                best = key
        if best is not None:
            req = self._lanes[best].popleft()
            self._size -= 1
            if not self._lanes[best]:
                del self._lanes[best]    # vt survives for fairness history
            self._vnow = self._vt[best]
            self._vt[best] += 1.0 / self._weights.get(best, 1.0)
            return req
        if self._sentinels > 0:
            self._sentinels -= 1
            return _SENTINEL
        return None

    def get(self, timeout: Optional[float] = None):
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._cond:
            while True:
                item = self._pop_locked()
                if item is not None:
                    return item
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        item = self._pop_locked()
                        if item is not None:
                            return item
                        raise Empty
                    self._cond.wait(remaining)

    def get_nowait(self):
        with self._cond:
            item = self._pop_locked()
            if item is None:
                raise Empty
            return item


class MicroBatcher:
    """Coalesce submitted rows into batches for ``run_batch``.

    run_batch: callable(List[Request]) — must resolve every request's
    future (result or exception). Exceptions escaping it are fanned out to
    the batch's unresolved futures so no caller ever hangs.
    """

    def __init__(self, run_batch: Callable[[List[Request]], None],
                 max_batch: int = 4096, max_delay_ms: float = 2.0,
                 workers: int = 1, stats=None,
                 max_queue: int = 0, backpressure: str = "reject",
                 timeout_ms: float = 0.0, health=None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_max_share: float = 0.0,
                 name: str = "lambdagap-serve-batcher") -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if backpressure not in ("reject", "block"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        self._run = run_batch
        self.max_batch = int(max_batch)
        self.max_delay = max(float(max_delay_ms), 0.0) / 1e3
        self.timeout = max(float(timeout_ms), 0.0) / 1e3
        self.backpressure = backpressure
        self.stats = stats
        self.health = health
        self._q = FairQueue(maxsize=max(int(max_queue), 0),
                            weights=tenant_weights,
                            max_share=tenant_max_share)
        self._closed = False
        # serializes the closed-flag check against enqueue: a submit that
        # saw _closed == False enqueued BEFORE close() put the sentinels,
        # so the fair queue's drain-first contract guarantees a worker
        # resolves it (the old check-then-put race could strand a future
        # on a dead queue forever)
        self._submit_lock = threading.Lock()
        # >1 workers overlap independent batch dispatches (jitted calls
        # release the GIL while executing); correctness is per-batch, so
        # workers share nothing but the queue and the stats lock
        self._threads = [threading.Thread(target=self._loop, daemon=True,
                                          name=f"{name}-{i}")
                         for i in range(max(int(workers), 1))]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    def submit(self, x: np.ndarray, model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue [n, D] float32 rows; returns the Future the worker will
        resolve. Thread-safe. Raises ``RuntimeError`` after close and
        :class:`ServeOverloaded` when the bounded queue is full — or the
        tenant is over its admission quota — under the ``reject`` policy
        (``block`` waits for space instead)."""
        deadline = (time.perf_counter() + self.timeout
                    if self.timeout > 0 else None)
        req = Request(x, deadline=deadline, model=model, tenant=tenant)
        while True:
            with self._submit_lock:
                if self._closed:
                    raise RuntimeError("batcher closed")
                verdict = self._q.try_put(req)
                if verdict == "ok":
                    return req.future
                if self.backpressure == "reject":
                    if self.stats is not None:
                        self.stats.record_rejected(tenant=tenant)
                    if verdict == "quota":
                        raise ServeOverloaded(
                            f"tenant {tenant!r} is over its admission quota "
                            f"({self._q.max_share:.0%} of "
                            f"{self._q.maxsize} queue slots); retry later "
                            "or raise serve_tenant_max_share") from None
                    raise ServeOverloaded(
                        f"serve queue full ({self._q.maxsize} requests); "
                        "retry later or raise serve_max_queue") from None
            # block policy: wait for the workers to drain, outside the lock
            # (never hold the submit lock across a blocking wait)
            time.sleep(0.0005)

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, flush everything already queued, join the
        workers. Queued requests are never dropped: the fair queue hands
        out shutdown sentinels only once every lane is empty, so a worker
        always drains accepted requests before exiting."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        self._q.put_sentinel(len(self._threads))
        for t in self._threads:
            t.join(timeout)

    # ------------------------------------------------------------------
    def _shed(self, req: Request) -> None:
        """Resolve an expired request with ServeTimeout (pre-dispatch)."""
        if not req.future.done():
            waited = time.perf_counter() - req.t_submit
            req.future.set_exception(ServeTimeout(
                f"request deadline expired after {waited * 1e3:.1f}ms in "
                "queue (serve_timeout_ms); shed before dispatch"))
        if self.stats is not None:
            self.stats.record_timeout(model=req.model, tenant=req.tenant)

    def _loop(self) -> None:
        drain = False
        while True:
            try:
                first = self._q.get(timeout=0.1)
            except Empty:
                if drain or self._closed:
                    break
                continue
            if first is _SENTINEL:
                break
            if first.expired():
                self._shed(first)
                continue
            batch = [first]
            rows = first.x.shape[0]
            deadline = first.t_submit + self.max_delay
            while rows < self.max_batch:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    # opportunistic non-blocking drain past the deadline:
                    # anything already queued still joins this dispatch
                    try:
                        nxt = self._q.get_nowait()
                    except Empty:
                        break
                else:
                    try:
                        nxt = self._q.get(timeout=wait)
                    except Empty:
                        break
                if nxt is _SENTINEL:
                    drain = True
                    break
                if nxt.expired():
                    self._shed(nxt)
                    continue
                batch.append(nxt)
                rows += nxt.x.shape[0]
            self._dispatch(batch, rows)
            if drain:
                break

    def _dispatch(self, batch: List[Request], rows: int) -> None:
        # final shed pass: a request can expire between joining the batch
        # window and the dispatch itself
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.expired(now):
                self._shed(r)
            else:
                live.append(r)
        if not live:
            return
        if self.stats is not None:
            self.stats.record_batch(len(live), sum(r.x.shape[0]
                                                   for r in live))
        try:
            self._run(live)
        except BaseException as e:  # noqa: BLE001 — worker must survive
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
            if self.stats is not None:
                self.stats.record_error()
            if self.health is not None:
                self.health.note_error()
        else:
            if self.health is not None:
                self.health.note_ok()
