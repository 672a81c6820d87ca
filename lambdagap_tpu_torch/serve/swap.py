"""Atomic model hot-swap: load, pre-warm, flip a generation pointer.

The port of ``lambdagap_tpu/serve/swap.py``. The protocol is read-copy-
update:

1. the new model text loads and compiles into a fresh
   :class:`~lambdagap_tpu_torch.serve.cache.CompiledForestCache` off the
   serving path (its padding buckets are pre-warmed, so post-swap requests
   pay no one-time cost);
2. the controller publishes ONE reference (its own ``active``, or the
   registry entry's residency pointer) — an atomic store under the GIL;
3. readers (the batcher workers) snapshot that reference once per batch
   and use the snapshot for the whole dispatch.

In-flight batches finish on the forest they started with and new batches
see the new one: every response carries exactly one generation's
predictions. A swap whose load or build raises never publishes (rollback
is structural) and feeds a consecutive-failure circuit breaker;
with the circuit open, further swaps are rejected fast
(:class:`~lambdagap_tpu_torch.guard.degrade.SwapRejected`) until the
cooldown admits a probe.

Device: a swap source given as a path or as text loads on the device it
is asked for (the server's), never on the default card behind a CPU
server's back; a booster object already on another device is refused,
never moved silently.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from ..guard.degrade import CircuitBreaker, SwapFailed, SwapRejected
from ..utils import log


def load_booster(source, params=None, device: Optional[torch.device] = None):
    """Resolve a swap source into a GBDT: an in-memory ``Booster``/``GBDT``
    passes through; anything else is a model file path or model text
    (``models.model_text.read_model_source``), loaded with ``params``.

    ``device``: where the forest must live. Text and paths load there
    (``device_type`` set from it unless ``params`` name one); a forest
    that ends up anywhere else raises ValueError."""
    from ..config import Config
    from ..models.gbdt import GBDT
    from ..models.model_text import read_model_source
    if hasattr(source, "_booster"):          # basic.Booster
        gbdt = source._booster
    elif isinstance(source, GBDT):
        gbdt = source
    else:
        p = dict(params or {})
        if device is not None:
            p.setdefault("device_type", device.type)
        gbdt = GBDT.from_model_string(read_model_source(source),
                                      Config.from_params(p))
    if device is not None and torch.device(gbdt.device) != device:
        raise ValueError(f"the swapped-in forest is on {gbdt.device}, the "
                         f"server on {device}; load it there (params "
                         "device_type) instead of moving it")
    return gbdt


class SwapController:
    """One model's swap protocol: load, build and pre-warm OFF the serving
    path, then publish the new forest; a failure publishes nothing and
    feeds the breaker, and an open breaker rejects up front.

    Standalone, the controller holds the published forest itself
    (``active``, read lock-free by the serving path). The registry gives
    each of its entries one controller and passes ``generation`` (the
    entry's current generation) and ``publish(gbdt, cache)`` (its
    admission under the registry lock). ``_lock`` only serializes writers:
    concurrent swaps of one model apply in call order.
    """

    def __init__(self, build_cache: Callable, stats=None,
                 breaker: Optional[CircuitBreaker] = None,
                 device: Optional[torch.device] = None,
                 name: str = "default",
                 generation: Optional[Callable[[], int]] = None,
                 publish: Optional[Callable] = None) -> None:
        self._build = build_cache        # (gbdt, generation) -> cache
        self._stats = stats
        self.breaker = breaker if breaker is not None else CircuitBreaker(0)
        self.device = device
        self.name = name
        self._generation = generation or (
            lambda: -1 if self.active is None else self.active.generation)
        self._publish = publish or self._set_active
        self._lock = threading.Lock()
        self.active = None               # standalone: CompiledForestCache

    def _set_active(self, gbdt, cache) -> None:
        self.active = cache              # atomic flip

    @property
    def generation(self) -> int:
        return self._generation()

    def install(self, gbdt) -> int:
        """Standalone: the initial model (generation 0), or a swap of an
        already-loaded booster object without the breaker."""
        with self._lock:
            gen = self._generation() + 1
            cache = self._build(gbdt, gen)
            self._publish(gbdt, cache)
        if gen > 0 and self._stats is not None:
            self._stats.record_swap()
        return gen

    def swap(self, source, params=None, background: bool = False):
        """Swap to a new model (path / model text / Booster / GBDT).

        Synchronous by default: returns the new generation once the flip
        happened. ``background=True`` runs load+warm+flip on a daemon
        thread and returns it immediately (serving continues on the old
        generation until the flip).

        A failed load/build raises :class:`SwapFailed` WITHOUT touching
        the served generation and feeds the circuit breaker; an open
        circuit rejects the swap up front with :class:`SwapRejected`."""

        def work() -> int:
            if not self.breaker.allow():
                raise SwapRejected(
                    f"swap circuit for model {self.name!r} open after "
                    f"{self.breaker.consecutive_failures} consecutive "
                    f"failures; serving continues on generation "
                    f"{self.generation} (cooldown "
                    f"{self.breaker.cooldown_s:g}s)")
            try:
                gbdt = load_booster(source, params, self.device)
                with self._lock:
                    gen = self._generation() + 1
                    # writer-only lock: readers take the published forest
                    # lock-free, so the build convoys no request
                    cache = self._build(gbdt, gen)
                    self._publish(gbdt, cache)
            except Exception as exc:
                raise self.failed("swap", exc) from exc
            self.breaker.record_success()
            if self._stats is not None:
                self._stats.record_swap()
            log.info("serve: swapped model %r to generation %d (%s engine, "
                     "pre-warmed before the flip)", self.name, gen,
                     cache.engine)
            return gen

        if background:
            t = threading.Thread(target=work, daemon=True,
                                 name=f"lambdagap-serve-swap-{self.name}")
            t.start()
            return t
        return work()

    def swap_delta(self, base_text: str, delta) -> int:
        """Delta hot-swap (serve/delta.py): the new model text is
        ``base_text`` (the resident host model's) plus the appended-trees
        frame, then the :meth:`swap` path. A frame that does not apply
        raises :class:`SwapFailed` through the same breaker-fed rollback."""
        from .delta import apply_delta
        try:
            new_text = apply_delta(base_text, delta)
        except Exception as exc:
            raise self.failed("delta swap", exc) from exc
        return self.swap(new_text)

    def failed(self, what: str, exc: Exception) -> SwapFailed:
        """Record a failed swap (breaker, stats, log) and return the
        :class:`SwapFailed` to raise; the served generation is untouched."""
        self.breaker.record_failure()
        if self._stats is not None:
            self._stats.record_swap_failure()
        gen = self.generation
        log.warning("serve: %s of model %r failed (%s); generation %d keeps "
                    "serving (breaker: %s)", what, self.name, exc, gen,
                    self.breaker.state())
        return SwapFailed(f"{what} of model {self.name!r} failed ({exc}); "
                          f"serving continues on generation {gen}")
