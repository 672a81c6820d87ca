"""predict_stream: out-of-core batch scoring.

The port of ``lambdagap_tpu/infer/stream.py``. Offline scoring of more
rows than the card holds — backfills, feature materialization,
``pred_contrib`` exports — runs window by window:

* row windows of a host matrix, an ``np.memmap`` or a
  ``ShardedBinnedDataset`` go up through the H2D ring
  (``data.stream.ShardRing``: pinned slots, a copy stream, one event a
  slot; phases ``h2d_prefetch`` / ``chunk_wait``) to the configured engine
  — ``compiled`` (the fused ``predict_kernel``, one launch a window),
  ``tensor`` or ``scan``; a binned source traverses the inner-feature bin
  tables through the tensor engine (``compiled`` demotes to it with the
  JAX warning) — plus averaging and the objective's conversion on the
  device unless ``raw_score``;
* the scores come back through :class:`ScoreRing`: each window's tile is
  copied into a pinned slot behind the window's launches, with an event
  the host waits on before numpy reads the slot (phase ``d2h_scores``), so
  the copy of window ``k`` overlaps the launches of window ``k+1``;
* a ragged last window is padded to a power-of-two bucket
  (:func:`_pow2_bucket`), as the JAX package pads it; padding rows are
  scored and dropped;
* :class:`CoTenantThrottle` slows the fetching of windows while a serving
  fleet's goodput signals say it is pressured (bounded backoff,
  ``guard/backoff.py``). The SignalPlane is not ported: the source is any
  callable returning the signals dict, or any object with ``snapshot()``.
* ``pred_contrib`` runs kernel S (``models/shap.tree_shap``) a window at a
  time through the same two rings.

Every engine scores each row on its own, so the scores are bit-equal to
the resident ``GBDT.predict_raw`` / ``predict`` on the same device for
every window size and raggedness, and to the JAX package's
``predict_stream`` where the JAX engines equal the port's
(``tests/test_torch_predict_stream.py``). A data file path is parsed a
window at a time (:class:`_FileSource`). ``mesh_shape`` row sharding and
the profiler window (``profile_stream_start_window``) are not ported and
raise by name.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..data.stream import PhaseClock, ShardedBinnedDataset, ShardRing, \
    WindowPump
from ..guard.backoff import Backoff
from ..utils import log

_ROADMAP = "(ROADMAP.md, Queue 1)"


# ---------------------------------------------------------------------------
# the D2H score ring
# ---------------------------------------------------------------------------
class ScoreRing:
    """Bounded D2H ring for per-window score tiles, the mirror image of
    the H2D ``ShardRing``. On the card ``put`` copies a window's device
    tile into a pinned slot (``non_blocking``, on the current stream, so it
    queues behind the window's launches) and records the slot's event;
    ``wait_ready`` waits on the OLDEST slot's event before numpy reads it.
    A slot is reused ``depth`` windows later, after its tile was read. Both
    run under ``d2h_scores``. On the CPU the tiles are the tensors
    themselves."""

    def __init__(self, device: torch.device, depth: int = 2,
                 clock: Optional[PhaseClock] = None) -> None:
        self.device = device
        self.depth = max(int(depth), 1)
        self.clock = clock if clock is not None else PhaseClock()
        self._queue: deque = deque()
        if device.type == "cuda":
            self._host = [None] * self.depth
            self._events = [torch.cuda.Event() for _ in range(self.depth)]
            self._next = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def full(self) -> bool:
        return len(self._queue) >= self.depth

    def put(self, key, scores: torch.Tensor) -> None:
        with self.clock.phase("d2h_scores"):
            if self.device.type != "cuda":
                self._queue.append((key, scores, None))
                return
            i = self._next
            self._next = (i + 1) % self.depth
            nb = scores.numel() * scores.element_size()
            buf = self._host[i]
            if buf is None or buf.numel() < nb:
                buf = torch.empty(1 << max(int(nb - 1).bit_length(), 12),
                                  dtype=torch.uint8, pin_memory=True)
                self._host[i] = buf
            host = buf[:nb].view(scores.dtype).view(scores.shape)
            host.copy_(scores, non_blocking=True)
            self._events[i].record(torch.cuda.current_stream(self.device))
            self._queue.append((key, host, self._events[i]))

    def wait_ready(self):
        """(key, host numpy tile) of the oldest slot, its copy landed. The
        tile is a view of the pinned slot: read it before the next
        ``depth`` puts."""
        key, host, ev = self._queue.popleft()
        with self.clock.phase("d2h_scores"):
            if ev is not None:
                ev.synchronize()
            return key, host.numpy()


# ---------------------------------------------------------------------------
# the co-tenant throttle
# ---------------------------------------------------------------------------
class CoTenantThrottle:
    """Window-fetch throttle driven by a serving fleet's goodput signals
    (``lambdagap_tpu/infer/stream.py:111-180``).

    ``signal_source`` is any object with ``snapshot()`` or any callable
    returning a signals dict with a ``goodput`` block (``knee_rps``,
    ``knee_margin``, ``good_fraction``, ``good_ratio``). A check is
    pressured when the offered load is at or past the knee (``knee_margin``
    at or under the headroom) or goodput is below the fleet's
    ``good_ratio``; each pressured check sleeps one bounded-backoff delay
    before the next window is fetched, and one healthy check resets the
    backoff. A source that raises is logged and the window runs
    unthrottled. The object is the ``WindowPump`` gate."""

    def __init__(self, signal_source, *, knee_margin: float = 0.1,
                 backoff: Optional[Backoff] = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self._source = signal_source
        self.knee_margin = float(knee_margin)
        self.backoff = backoff if backoff is not None else Backoff(
            base_s=0.05, factor=2.0, max_s=2.0, jitter=0.1, seed=18)
        self._sleep = sleep
        self.checks = 0
        self.waits = 0
        self.waited_s = 0.0
        self.engaged = False

    def _signals(self) -> Optional[dict]:
        src = self._source
        if src is None:
            return None
        try:
            snap = src.snapshot() if hasattr(src, "snapshot") else src()
        except Exception as e:  # a dead signal source must not kill the job
            log.warning("predict_stream throttle: signal source failed "
                        "(%s); running unthrottled this window", e)
            return None
        return snap if isinstance(snap, dict) else None

    def __call__(self) -> None:
        sig = self._signals()
        if sig is None:
            return
        good = sig.get("goodput") or {}
        self.checks += 1
        knee = float(good.get("knee_rps", 0.0) or 0.0)
        margin = float(good.get("knee_margin", 0.0) or 0.0)
        frac = float(good.get("good_fraction", 1.0))
        ratio = float(good.get("good_ratio", 0.9))
        pressured = (knee > 0.0 and margin <= self.knee_margin) \
            or frac < ratio
        if pressured:
            delay = self.backoff.note_failure()
            self.engaged = True
            self.waits += 1
            self.waited_s += delay
            self._sleep(delay)
        else:
            self.backoff.note_success()
            self.engaged = False

    def snapshot(self) -> dict:
        return {"checks": self.checks, "waits": self.waits,
                "waited_s": round(self.waited_s, 6),
                "engaged": self.engaged,
                "backoff": self.backoff.snapshot()}


def _pow2_bucket(rows: int, cap: int, mult: int) -> int:
    """Next power of two at or above ``rows``, capped at ``cap`` and
    rounded up to a multiple of ``mult`` (``infer/stream.py:210-220``)."""
    b = 1
    while b < rows:
        b <<= 1
    b = min(b, cap)
    b = -(-b // max(mult, 1)) * max(mult, 1)
    return max(b, mult, 1)


# ---------------------------------------------------------------------------
# the per-window scorer
# ---------------------------------------------------------------------------
def _build_scorer(gb, idx, trees, es_freq: int, binned: bool,
                  raw_score: bool, start_iteration: int,
                  num_iteration: int):
    """``x [bucket, F] (device) -> [K, bucket]`` scores on the device:
    the engine's raw scores, averaged and converted unless ``raw_score``,
    each step the resident path's own on the same device."""
    from ..models.gbdt import dispatch_forest_predict
    from ..ops.predict import build_forest_blocks, forest_to_arrays
    from ..ops.predict_tensor import build_tree_tiles
    cfg = gb.config
    K = gb.num_tree_per_iteration
    n_iters = max(1, len(idx) // max(K, 1))
    engine = cfg.predict_engine
    margin = float(cfg.pred_early_stop_margin)
    if binned and engine == "compiled":
        log.warning("predict_stream: predict_engine=compiled scores "
                    "binned windows through the tensor engine "
                    "(bit-identical; the compiled artifact serves raw "
                    "rows)")
    if not binned and engine == "compiled":
        base = gb._compiled_forest(start_iteration, num_iteration,
                                   es_freq).predict
    elif binned:
        forest, depth = forest_to_arrays(
            trees, feature_meta=gb.learner.meta_host,
            use_inner_feature=True, device=gb.device)
        tree_class = [i % K for i in idx]
        blocks = (build_tree_tiles(forest, tree_class, cfg.predict_tree_tile)
                  if engine in ("tensor", "compiled")
                  else build_forest_blocks(forest, tree_class))

        def base(x):
            return dispatch_forest_predict(
                cfg, x, forest, tree_class, K, depth, binned=True,
                early_stop_freq=es_freq, early_stop_margin=margin,
                blocks=blocks)
    else:
        forest, depth, tree_class, blocks, linear = gb._device_forest(idx)

        def base(x):
            return dispatch_forest_predict(
                cfg, x, forest, tree_class, K, depth, binned=False,
                early_stop_freq=es_freq, early_stop_margin=margin,
                blocks=blocks, has_linear=linear)

    average = bool(gb.average_output) and n_iters > 1
    convert = (None if raw_score or gb.objective is None
               else gb.objective.convert_output)

    def score(x: torch.Tensor) -> torch.Tensor:
        out = base(x)
        if average:
            out = out / torch.tensor(n_iters, dtype=torch.float32,
                                     device=out.device)
        if convert is not None:
            out = convert(out)
        return out

    return score


def _cached_scorer(gb, idx, trees, es_freq, binned, raw_score,
                   start_iteration, num_iteration):
    """One scorer per (model slice, engine, options), cached on the
    booster and keyed on its ``generation``, like its other predict-side
    views (``infer/stream.py:624-641``)."""
    cfg = gb.config
    key = (gb.generation, len(gb.models), idx[0], idx[-1], len(idx),
           cfg.predict_engine, es_freq, bool(binned), bool(raw_score),
           cfg.predict_tree_tile)
    cache = getattr(gb, "_pstream_cache", None)
    if cache is None or cache[0] != key:
        gb._pstream_cache = (key, _build_scorer(
            gb, idx, trees, es_freq, binned, raw_score, start_iteration,
            num_iteration))
    return gb._pstream_cache[1]


# ---------------------------------------------------------------------------
# row sources
# ---------------------------------------------------------------------------
class _MatrixSource:
    """A dense host matrix (ndarray or ``np.memmap``): windows are row
    slices cast to f32 one window at a time, so a memmap never becomes a
    whole float copy."""

    binned = False

    def __init__(self, gb, data) -> None:
        if getattr(data, "ndim", None) != 2:
            log.fatal("predict_stream expects a 2-D matrix, got shape %s",
                      (getattr(data, "shape", None),))
        self.data = gb._check_predict_shape(data)
        self.n_rows = int(self.data.shape[0])
        self.n_cols = int(self.data.shape[1])

    def blocks(self, window_rows: int):
        for lo in range(0, self.n_rows, window_rows):
            yield np.ascontiguousarray(self.data[lo:lo + window_rows],
                                       dtype=np.float32)


class _ShardedSource:
    """A ShardedBinnedDataset on the model's training bins: windows are
    dataset-order ``row_block`` copies, traversed through the
    inner-feature bin tables."""

    binned = True

    def __init__(self, gb, ds: ShardedBinnedDataset) -> None:
        if getattr(gb, "learner", None) is None or gb.train_set is None:
            log.fatal("predict_stream on a binned dataset needs the "
                      "training feature metadata (a booster trained in "
                      "this process); a loaded model scores raw matrices")
        if len(ds.used_features) != len(gb.train_set.used_features):
            log.fatal("predict_stream: dataset bin layout (%d used "
                      "features) does not match the model's training "
                      "layout (%d); build the dataset with "
                      "reference=train_set", len(ds.used_features),
                      len(gb.train_set.used_features))
        self.ds = ds
        self.n_rows = int(ds.num_data)
        self.n_cols = int(ds.shards[0].shape[1])

    def blocks(self, window_rows: int):
        n = self.ds.num_data
        for lo in range(0, n, window_rows):
            yield self.ds.row_block(lo, min(lo + window_rows, n))


class _FileSource:
    """A text data file (CSV / TSV / LibSVM) parsed a window at a time
    through the loader's block reader (``data/loader.PredictFile``; the
    JAX package's ``iter_predict_blocks``, ``infer/stream.py:344``): one
    window of parsed rows on the host at a time, with the column handling
    of ``Booster.predict(path)``."""

    binned = False

    def __init__(self, gb, path) -> None:
        from ..data.loader import PredictFile
        self.gb = gb
        self.file = PredictFile(str(path), gb.config)
        self.n_rows = self.file.n_rows
        self.n_cols = self.file.n_cols

    def blocks(self, window_rows: int):
        for blk in self.file.blocks(window_rows):
            yield np.ascontiguousarray(self.gb._check_predict_shape(blk),
                                       dtype=np.float32)


def _as_source(gb, data):
    if isinstance(data, ShardedBinnedDataset):
        return _ShardedSource(gb, data)
    if isinstance(data, (str, os.PathLike)):
        return _FileSource(gb, data)
    return _MatrixSource(gb, data if isinstance(data, np.ndarray)
                         else np.asarray(data))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def predict_stream(gb, data, *, start_iteration: int = 0,
                   num_iteration: int = -1, raw_score: bool = False,
                   pred_contrib: bool = False, window_rows: int = 0,
                   out: Optional[np.ndarray] = None, signal_source=None,
                   throttle: Optional[CoTenantThrottle] = None,
                   stats_out: Optional[dict] = None) -> np.ndarray:
    """Score ``data`` (a 2-D matrix, an ``np.memmap``, a data file path or
    a ``ShardedBinnedDataset`` on the model's bins) window by window.
    Returns what the resident predict returns — ``[N]`` / ``[N, K]``
    scores (``raw_score``: bit-equal to ``predict_raw``), or with
    ``pred_contrib`` the ``[N, F+1]`` / ``[N, K*(F+1)]`` SHAP matrix of
    f32-rounded rows, as the JAX package's — or ``out`` (e.g. an
    ``np.memmap``), written in place. ``signal_source`` / ``throttle`` arm
    the co-tenant gate; ``stats_out`` receives the run report (the JAX
    package's keys; ``mesh`` is None, ``records`` one record a window)."""
    cfg = gb.config
    if cfg.mesh_shape:
        raise NotImplementedError(
            f"mesh_shape is not ported to lambdagap_tpu_torch yet "
            f"{_ROADMAP}: predict_stream scores on one device")
    if cfg.profile_stream_start_window >= 0:
        raise NotImplementedError(
            "profile_stream_start_window (the predict_stream profiler "
            f"window) is not ported to lambdagap_tpu_torch yet {_ROADMAP}")
    src = _as_source(gb, data)
    K = gb.num_tree_per_iteration
    idx = gb._model_slice(start_iteration, num_iteration)
    if not idx:
        res = np.zeros((K, src.n_rows), dtype=np.float32)
        return res[0] if K == 1 else res.T
    trees = [gb._tree(i) for i in idx]
    if src.binned and any(getattr(t, "is_linear", False) for t in trees):
        log.fatal("predict_stream: linear-leaf forests traverse raw rows "
                  "(the per-leaf dot product needs raw features); score a "
                  "matrix or file source instead of a binned dataset")

    gate = throttle
    if gate is None and signal_source is not None \
            and cfg.predict_stream_throttle != "off":
        gate = CoTenantThrottle(
            signal_source, knee_margin=cfg.predict_stream_knee_margin,
            backoff=Backoff(base_s=cfg.predict_stream_backoff_s, factor=2.0,
                            max_s=cfg.predict_stream_backoff_max_s,
                            jitter=0.1, seed=18))
    elif gate is not None and cfg.predict_stream_throttle == "off":
        gate = None
    depth = int(cfg.predict_stream_depth or cfg.stream_prefetch_depth)
    clock = PhaseClock()
    ring = ShardRing(gb.device, depth, clock)
    sring = ScoreRing(gb.device, depth, clock)

    if pred_contrib:
        return _contrib_stream(gb, src, idx, start_iteration, num_iteration,
                               window_rows, out, gate, stats_out, ring,
                               sring)

    es_freq = gb._es_freq()
    cap = int(window_rows or cfg.predict_stream_window_rows)
    cap = _pow2_bucket(cap, cap, 1)
    # a small call never pays a full window of padding
    W = min(cap, _pow2_bucket(src.n_rows, cap, 1))
    scorer = _cached_scorer(gb, idx, trees, es_freq, src.binned, raw_score,
                            start_iteration, num_iteration)
    t_start = time.perf_counter()
    metas: dict = {}
    buckets: set = set()
    records: list = []

    def windows():
        lo = 0
        for c, blk in enumerate(src.blocks(W)):
            w = blk.shape[0]
            b = W if w == W else _pow2_bucket(w, W, 1)
            if b != w:
                buf = np.zeros((b, blk.shape[1]), dtype=blk.dtype)
                buf[:w] = blk
                blk = buf
            buckets.add(b)
            metas[c] = (lo, w)
            yield c, (blk,)
            lo += w

    res = None if out is not None else np.empty((K, src.n_rows),
                                                dtype=np.float32)
    rows_done = 0

    def drain_one() -> None:
        nonlocal rows_done
        key, host = sring.wait_ready()
        lo, w = metas.pop(key)
        tile = host[:, :w]
        if out is None:
            res[:, lo:lo + w] = tile
        elif out.ndim == 1:
            out[lo:lo + w] = tile[0]
        else:
            out[lo:lo + w] = tile.T
        rows_done += w

    n_windows = 0
    for key, bufs in WindowPump(windows(), ring, gate=gate):
        t0 = time.perf_counter()
        w = metas[key][1]
        sring.put(key, scorer(bufs[0]))
        if sring.full:
            drain_one()
        records.append({"window": key, "rows": w,
                        "bucket": int(bufs[0].shape[0]),
                        "wall_s": round(time.perf_counter() - t0, 6)})
        n_windows += 1
    while len(sring):
        drain_one()
    wall = time.perf_counter() - t_start
    if stats_out is not None:
        stats_out.update({
            "rows": int(rows_done), "windows": n_windows,
            "window_rows": W, "buckets": sorted(buckets), "depth": depth,
            "engine": cfg.predict_engine, "mesh": None,
            "wall_s": round(wall, 6),
            "rows_per_s": round(rows_done / wall, 3) if wall > 0 else None,
            "phases": {k: round(v, 6) for k, v in clock.snapshot().items()},
            "records": records,
            "throttle": gate.snapshot() if gate is not None else None})
    if out is not None:
        return out
    return res[0] if K == 1 else res.T


def _contrib_stream(gb, src, idx, start_iteration, num_iteration,
                    window_rows, out, gate, stats_out, ring: ShardRing,
                    sring: ScoreRing) -> np.ndarray:
    """``pred_contrib`` window by window on kernel S (a linear forest's
    terms after it, ``GBDT._contrib_rows``): each window's f32-rounded rows
    (the JAX package's windows are f32) go up as float64, their ``[w, K,
    F+1]`` contributions come back through the score ring and are written
    straight into ``out`` when given."""
    if src.binned:
        log.fatal("predict_stream(pred_contrib=True) needs raw feature "
                  "rows (a matrix source); TreeSHAP attributes raw split "
                  "values")
    cfg = gb.config
    K = gb.num_tree_per_iteration
    W = int(window_rows or cfg.predict_stream_window_rows)
    F = src.n_cols
    n_iters = max(1, len(idx) // max(K, 1))
    max_f = max((f for i in idx for f in
                 gb._tree(i).split_feature[:gb._tree(i).num_internal]),
                default=-1)
    if max_f >= F:
        log.fatal("pred_contrib input has %d features but the model "
                  "splits on feature %d", F, max_f)
    t_start = time.perf_counter()
    width = K * (F + 1)
    res = None if out is not None else np.empty(
        (src.n_rows, F + 1) if K == 1 else (src.n_rows, width), np.float64)
    dest = out if out is not None else res
    spans: dict = {}

    def windows():
        lo = 0
        for c, blk in enumerate(src.blocks(W)):
            spans[c] = (lo, blk.shape[0])
            yield c, (np.ascontiguousarray(blk, dtype=np.float64),)
            lo += blk.shape[0]

    def drain_one() -> None:
        key, phi = sring.wait_ready()
        lo, w = spans.pop(key)
        if gb.average_output:
            phi = phi / n_iters
        dest[lo:lo + w] = phi[:, 0] if K == 1 else phi.reshape(w, width)

    n_windows = rows = 0
    for key, bufs in WindowPump(windows(), ring, gate=gate):
        sring.put(key, gb._contrib_rows(bufs[0], start_iteration,
                                        num_iteration))
        if sring.full:
            drain_one()
        rows += bufs[0].shape[0]
        n_windows += 1
    while len(sring):
        drain_one()
    wall = time.perf_counter() - t_start
    if stats_out is not None:
        stats_out.update({
            "rows": rows, "windows": n_windows, "window_rows": W,
            "pred_contrib": True, "wall_s": round(wall, 6),
            "rows_per_s": round(rows / wall, 3) if wall > 0 else None,
            "throttle": gate.snapshot() if gate is not None else None})
    return dest
