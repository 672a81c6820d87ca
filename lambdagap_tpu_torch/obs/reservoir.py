"""Bounded uniform reservoir sample — the percentile backbone shared by the
serve layer's latency stats and the training telemetry's iteration walls.

A copy of ``lambdagap_tpu/obs/reservoir.py`` (the port imports nothing of
the JAX package): O(cap) memory over unbounded streams, uniform
replacement, exact-ish quantiles. ``serve/stats.py`` reports its latency
percentiles through it.

The reservoir is a LIFTED aggregate: each kept value stands for
``seen / len(vals)`` stream items, which is exactly what makes fleet
merging possible. :meth:`Reservoir.state` exports that
aggregate form for the wire (bounded, quantile-preserving downsample) and
:func:`merge_states` recombines N replicas' states into one
weight-correct quantile view — no resampling, no randomness, so the
merged fleet quantiles are a deterministic function of the per-replica
snapshots.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple


class Reservoir:
    """Bounded latency sample with uniform reservoir replacement, so
    million-request streams keep O(cap) memory but exact-ish percentiles."""

    __slots__ = ("cap", "seen", "vals", "_rng")

    def __init__(self, cap: int = 100_000, seed: int = 0) -> None:
        self.cap = cap
        self.seen = 0
        self.vals: List[float] = []
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.seen += 1
        if len(self.vals) < self.cap:
            self.vals.append(v)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.cap:
                self.vals[j] = v

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        if not self.vals:
            return {f"p{int(q * 100)}": 0.0 for q in qs} | {
                "mean": 0.0, "max": 0.0}
        s = sorted(self.vals)
        out = {}
        for q in qs:
            k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
            out[f"p{int(q * 100)}"] = s[k]
        out["mean"] = sum(s) / len(s)
        out["max"] = s[-1]
        return out

    # -- the lifted aggregate form (fleet merging) --------
    def state(self, scale: float = 1.0, max_vals: int = 2048) -> Dict:
        """Wire form: ``{"seen": N, "vals": [...]}``. ``vals`` is the
        kept sample (optionally unit-scaled, e.g. s -> ms), downsampled
        past ``max_vals`` by evenly spaced picks from the SORTED sample —
        the downsample that moves quantiles least."""
        vals = sorted(self.vals)
        if len(vals) > max_vals:
            step = (len(vals) - 1) / (max_vals - 1)
            vals = [vals[int(round(i * step))] for i in range(max_vals)]
        return {"seen": self.seen,
                "vals": [v * scale for v in vals]}


def valid_state(s) -> bool:
    return (isinstance(s, dict) and isinstance(s.get("seen"), int)
            and isinstance(s.get("vals"), list))


class MergedReservoir:
    """Weight-correct quantile view over N reservoir states: each state's
    values carry weight ``seen / len(vals)``, so a replica that saw 10x
    the traffic moves the merged quantiles 10x as much — summing the
    underlying streams, not averaging the summaries."""

    __slots__ = ("seen", "_pairs")

    def __init__(self, pairs: Sequence[Tuple[float, float]],
                 seen: int) -> None:
        self._pairs = sorted(pairs)      # (value, weight)
        self.seen = seen

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        if not self._pairs:
            return {f"p{int(q * 100)}": 0.0 for q in qs} | {
                "mean": 0.0, "max": 0.0}
        total = sum(w for _v, w in self._pairs)
        out: Dict[str, float] = {}
        for q in qs:
            target = q * total
            cum = 0.0
            val = self._pairs[-1][0]
            for v, w in self._pairs:
                cum += w
                if cum >= target - 1e-12:
                    val = v
                    break
            out[f"p{int(q * 100)}"] = val
        out["mean"] = sum(v * w for v, w in self._pairs) / total
        out["max"] = self._pairs[-1][0]
        return out

    def state(self) -> Dict:
        """Re-export in the wire form (weights folded back by repeating
        nothing — vals keep their weights via ``seen``); good enough for
        a second-level merge of already-merged snapshots."""
        return {"seen": self.seen, "vals": [v for v, _w in self._pairs]}


def merge_states(states: Sequence[Optional[Dict]]) -> MergedReservoir:
    """Merge N ``Reservoir.state()`` dicts (Nones and malformed states
    contribute nothing — a half-scraped fleet still merges)."""
    pairs: List[Tuple[float, float]] = []
    seen = 0
    for s in states:
        if not valid_state(s) or not s["vals"]:
            continue
        w = max(s["seen"], len(s["vals"])) / len(s["vals"])
        seen += s["seen"]
        pairs.extend((float(v), w) for v in s["vals"])
    return MergedReservoir(pairs, seen)
