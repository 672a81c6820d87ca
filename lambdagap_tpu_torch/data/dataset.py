"""The binned training matrix and its metadata.

The port of the dense-numpy half of ``lambdagap_tpu/data/dataset.py``: the
reference's ``Dataset``/``Metadata`` (reference:
include/LightGBM/dataset.h:48-397; src/io/dataset.cpp) as one dense
row-major ``uint8``/``uint16`` matrix ``[num_data, num_used_features]``.
Bin finding samples rows with the same numpy ``RandomState`` draw as the
JAX package, so mappers and the binned matrix are equal to its own. The
matrix stays on the host here; the learner uploads it to its device once.

The EFB bundled matrix is built on demand
(:meth:`BinnedDataset.ensure_bundle`), as the JAX package builds it. The
metadata carries query groups (as boundaries) and per-row positions for
the ranking objectives and metrics. Streamed construction
(:meth:`BinnedDataset.from_sequences`) finds the boundaries over every row
with one ``QuantileSketch`` per feature and pushes row batches straight
into the binned matrix, as the JAX package does
(``lambdagap_tpu/data/dataset.py:110-129,227-300``); the host-sharded
``ShardedBinnedDataset`` is in :mod:`lambdagap_tpu_torch.data.stream`.
Under ``linear_tree`` a matrix-built dataset keeps its raw matrix as f32
(``raw``, the JAX package's ``dataset.py:159,208-211``): the linear leaves
fit and evaluate on raw feature values.

Rows are binned on the config's device (``device_type``): every numerical
column by kernel B (``ops/bin_cuda.bin_matrix``; its plain version on the
CPU), where the JAX package runs its host C++ binner; categorical columns
by their mapper on the host, as there.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops.bin_cuda import BinTable, bin_matrix
from ..utils import log
from ..utils.device import resolve_device
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper, QuantileSketch,
                      bounds_table)

MISSING_CODES = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}


@dataclass
class Metadata:
    """Labels, weights, query boundaries, positions, init scores
    (reference: include/LightGBM/dataset.h:48-397)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    query_boundaries: Optional[np.ndarray] = None   # int32 [num_queries+1]
    query_weights: Optional[np.ndarray] = None
    init_score: Optional[np.ndarray] = None          # [num_data * num_class]
    position: Optional[np.ndarray] = None            # int32 [num_data]
    position_ids: Optional[List[str]] = None

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    def set_group(self, group: Optional[np.ndarray]) -> None:
        """Group sizes (LightGBM's convention) or per-row query ids."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group)
        if (self.label is not None and len(group) == len(self.label)
                and len(group) > 0
                and not _looks_like_sizes(group, len(self.label))):
            # per-row query ids -> boundaries
            change = np.nonzero(np.diff(group))[0] + 1
            self.query_boundaries = np.concatenate(
                [[0], change, [len(group)]]).astype(np.int32)
        else:
            self.query_boundaries = np.concatenate(
                [[0], np.cumsum(group.astype(np.int64))]).astype(np.int32)

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            log.fatal("Length of label (%d) != num_data (%d)",
                      len(self.label), num_data)
        if self.weight is not None and len(self.weight) != num_data:
            log.fatal("Length of weight (%d) != num_data (%d)",
                      len(self.weight), num_data)
        if (self.query_boundaries is not None
                and self.query_boundaries[-1] != num_data):
            log.fatal("Sum of query counts (%d) != num_data (%d)",
                      int(self.query_boundaries[-1]), num_data)
        if self.position is not None and len(self.position) != num_data:
            log.fatal("Length of position (%d) != num_data (%d)",
                      len(self.position), num_data)


def _looks_like_sizes(group: np.ndarray, num_data: int) -> bool:
    """Whether ``group`` sums to the row count (sizes, not query ids)."""
    try:
        return int(np.sum(group)) == num_data
    except (TypeError, ValueError):
        return False


def _load_forced_bounds(config: Config) -> Dict[int, List[float]]:
    """forced bin boundaries (reference: DatasetLoader forced_bin_bounds_,
    examples/regression/forced_bins.json)."""
    forced: Dict[int, List[float]] = {}
    if config.forcedbins_filename:
        with open(config.forcedbins_filename) as f:
            for entry in json.load(f):
                forced[int(entry["feature"])] = \
                    [float(v) for v in entry["bin_upper_bound"]]
    return forced


def _finish_bins(ds: "BinnedDataset") -> None:
    """used_features, feature_num_bins and bin_offsets from freshly built
    mappers (``lambdagap_tpu/data/dataset.py:93-107``)."""
    ds.used_features = [j for j, m in enumerate(ds.mappers)
                        if not m.is_trivial]
    if not ds.used_features:
        log.fatal("Cannot construct Dataset: all features are trivial "
                  "(constant); check your input data")
    ds.feature_num_bins = [ds.mappers[j].num_bin for j in ds.used_features]
    ds.bin_offsets = [int(v) for v in np.concatenate(
        [[0], np.cumsum(ds.feature_num_bins)[:-1]])]


def _mappers_from_sketches(ds: "BinnedDataset", sketches, config: Config,
                           categorical: set) -> None:
    """Per-feature BinMappers from incremental quantile sketches, the
    streaming analog of ``_find_bins`` (``lambdagap_tpu/data/dataset.py:
    110-129``): boundaries over every row pushed, no row sample."""
    forced = _load_forced_bounds(config)
    ds.mappers = []
    for j, sk in enumerate(sketches):
        ds.mappers.append(sk.to_mapper(
            max_bin=(config.max_bin_by_feature[j]
                     if j < len(config.max_bin_by_feature)
                     else config.max_bin),
            min_data_in_bin=config.min_data_in_bin,
            bin_type=(BIN_CATEGORICAL if j in categorical
                      else BIN_NUMERICAL),
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
            forced_bounds=forced.get(j, ())))
    _finish_bins(ds)


def bin_dtype(feature_num_bins) -> type:
    """u8 bins while every feature has at most 256, else u16."""
    return np.uint8 if max(feature_num_bins, default=2) <= 256 \
        else np.uint16


def _batches(seq, length: int, default: int):
    """``seq``'s rows as float64 blocks of its ``batch_size`` rows."""
    bs = max(int(getattr(seq, "batch_size", default)), 1)
    for lo in range(0, length, bs):
        yield lo, np.asarray(seq[lo:min(lo + bs, length)], np.float64)


class BinnedDataset:
    """The constructed, immutable training matrix
    (reference analog: Dataset after ``Construct``, src/io/dataset.cpp).

    binned : np.ndarray uint8/uint16 [num_data, num_used_features]
    mappers : one BinMapper per *original* feature
    used_features : original indices of the non-trivial features
    feature_num_bins / bin_offsets : bins and cumulative offsets per used
    feature
    """

    def __init__(self) -> None:
        self.binned: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.feature_num_bins: List[int] = []
        self.bin_offsets: List[int] = []
        self.num_data = 0
        self.num_total_features = 0
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin = 255
        self.raw: Optional[np.ndarray] = None   # kept under linear_tree
        self._bin_table: Optional[BinTable] = None
        self._bundle = None
        self._bundle_built = False

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[np.ndarray] = None,
                    weight: Optional[np.ndarray] = None,
                    init_score: Optional[np.ndarray] = None,
                    group: Optional[np.ndarray] = None,
                    position: Optional[np.ndarray] = None,
                    categorical_features: Sequence[int] = (),
                    feature_names: Optional[Sequence[str]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Construct from a dense float matrix: sample rows, find bins, then
        bin every row (reference: DatasetLoader::ConstructFromSampleData,
        src/io/dataset_loader.cpp:593). With ``reference`` the training
        set's mappers are reused (a validation set)."""
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("Training data must be 2-dimensional, got shape %s",
                      data.shape)
        ds = cls()
        ds.num_data, ds.num_total_features = data.shape
        ds.max_bin = config.max_bin
        ds.feature_names = (list(feature_names) if feature_names else
                            [f"Column_{i}"
                             for i in range(ds.num_total_features)])
        if reference is not None:
            ds._adopt_reference(reference)
        else:
            ds._find_bins(data, config, set(categorical_features))
        ds._push_data(data, resolve_device(config.device_type))
        if config.linear_tree:
            # linear leaves fit and evaluate on raw numeric values
            # (reference: Dataset raw_data retention under linear_tree)
            ds.raw = data.astype(np.float32)
        ds._attach_metadata(label, weight, group, init_score, position)
        return ds

    @classmethod
    def from_sequences(cls, seqs, config: Config, label=None, weight=None,
                       group=None, init_score=None, position=None,
                       categorical_features: Sequence[int] = (),
                       feature_names: Optional[Sequence[str]] = None,
                       reference: Optional["BinnedDataset"] = None
                       ) -> "BinnedDataset":
        """Streaming construction from row-batch readers (``Sequence``s;
        ``lambdagap_tpu/data/dataset.py:227-300``): one sketch pass over
        every row finds the bin boundaries, a second pass pushes each batch
        straight into the binned matrix, so the float matrix never exists
        whole (reference: dataset.h:593 PushOneRow)."""
        lens = [len(s) for s in seqs]
        total = int(sum(lens))
        if total == 0:
            log.fatal("Cannot construct Dataset from empty sequences")
        F = np.asarray(seqs[0][0:1], dtype=np.float64).shape[1]
        ds = cls()
        ds.num_data, ds.num_total_features = total, F
        ds.max_bin = config.max_bin
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(F)])
        if reference is not None:
            ds._adopt_reference(reference)
        else:
            sketches = [QuantileSketch(budget=config.stream_sketch_budget)
                        for _ in range(F)]
            for s, ln in zip(seqs, lens):
                for _, blk in _batches(s, ln, 4096):
                    for j in range(F):
                        sketches[j].push(blk[:, j])
            _mappers_from_sketches(ds, sketches, config,
                                   set(categorical_features))
        binned = np.empty((total, len(ds.used_features)),
                          bin_dtype(ds.feature_num_bins))
        device = resolve_device(config.device_type)
        row0 = 0
        for s, ln in zip(seqs, lens):
            for lo, blk in _batches(s, ln, 4096):
                binned[row0 + lo:row0 + lo + len(blk)] = ds._bin_block(
                    blk, device)
            row0 += ln
        ds.binned = binned
        ds._attach_metadata(label, weight, group, init_score, position)
        return ds

    def _adopt_reference(self, reference: "BinnedDataset") -> None:
        """A validation set's bins: the training set's mappers
        (reference: Dataset::CreateValid, src/io/dataset.cpp)."""
        for k in ("mappers", "used_features", "feature_num_bins",
                  "bin_offsets", "feature_names", "max_bin", "_bin_table"):
            setattr(self, k, getattr(reference, k))

    def bin_table(self) -> BinTable:
        """The mappers' numerical bounds as kernel B reads them (built
        once)."""
        if self._bin_table is None:
            self._bin_table = BinTable(
                *bounds_table(self.mappers, self.used_features),
                num_used=len(self.used_features),
                out_dtype=bin_dtype(self.feature_num_bins))
        return self._bin_table

    def _bin_into(self, data: np.ndarray, out: np.ndarray,
                  device: torch.device) -> None:
        """Bin row block ``data`` ``[n, num_total_features]`` into ``out``
        ``[n, num_used_features]``: the numerical columns by B on
        ``device``, the categorical ones by their mapper."""
        bin_matrix(data, self.bin_table(), device, out)
        for k, j in enumerate(self.used_features):
            if self.mappers[j].bin_type == BIN_CATEGORICAL:
                out[:, k] = self.mappers[j].values_to_bins(data[:, j])

    def _bin_block(self, blk: np.ndarray,
                   device: torch.device) -> np.ndarray:
        """A float row block ``[n, num_total_features]`` binned to the
        used features' columns."""
        out = np.empty((blk.shape[0], len(self.used_features)),
                       bin_dtype(self.feature_num_bins))
        self._bin_into(blk, out, device)
        return out

    def _attach_metadata(self, label, weight, group, init_score,
                         position) -> None:
        md = self.metadata
        if label is not None:
            md.label = np.asarray(label, dtype=np.float32).reshape(-1)
        if weight is not None:
            md.weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if init_score is not None:
            md.init_score = np.asarray(init_score,
                                       dtype=np.float64).reshape(-1)
        if position is not None:
            md.position = np.asarray(position, dtype=np.int32).reshape(-1)
        md.set_group(group)
        md.check(self.num_data)

    def _find_bins(self, data: np.ndarray, config: Config,
                   categorical: set) -> None:
        """Sample rows and build per-feature BinMappers (reference:
        DatasetLoader::ConstructBinMappersFromTextData,
        src/io/dataset_loader.cpp:1072); the sample is the JAX package's
        ``RandomState(data_random_seed)`` draw."""
        n = self.num_data
        sample_cnt = min(config.bin_construct_sample_cnt, n)
        rng = np.random.RandomState(config.data_random_seed)
        if sample_cnt >= n:
            sample = data
        else:
            sample = data[np.sort(rng.choice(n, sample_cnt, replace=False))]
        forced = _load_forced_bounds(config)
        self.mappers = []
        for j in range(self.num_total_features):
            col = sample[:, j]
            # sparse convention: pass non-zero entries, infer zeros from total
            nz = col[~((col == 0.0) & ~np.isnan(col))]
            self.mappers.append(BinMapper.find_bin(
                nz, total_sample_cnt=len(col),
                max_bin=(config.max_bin_by_feature[j]
                         if j < len(config.max_bin_by_feature)
                         else config.max_bin),
                min_data_in_bin=config.min_data_in_bin,
                bin_type=(BIN_CATEGORICAL if j in categorical
                          else BIN_NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing,
                forced_bounds=forced.get(j, ())))
        _finish_bins(self)

    def _push_data(self, data: np.ndarray, device: torch.device) -> None:
        """Bin every row on ``device`` (:meth:`_bin_into`)."""
        binned = np.empty((self.num_data, len(self.used_features)),
                          bin_dtype(self.feature_num_bins))
        self._bin_into(data, binned, device)
        self.binned = binned

    # ------------------------------------------------------------------
    def ensure_bundle(self, config: Config):
        """The EFB bundled matrix (``data.bundling.Bundle``), or None when
        no multi-feature bundle forms or ``enable_bundle`` is off; built on
        the first call and kept (``lambdagap_tpu/data/dataset.py:386``).
        Only the fused learner reads it, so validation sets never pay the
        grouping scan or the second matrix."""
        if self._bundle_built:
            return self._bundle
        self._bundle_built = True
        if config.enable_bundle and self.binned is not None:
            from .bundling import build_bundle
            self._bundle = build_bundle(
                self.binned, np.asarray(self.feature_num_bins, np.int32),
                np.asarray([self.mappers[j].default_bin
                            for j in self.used_features], np.int32),
                config.max_conflict_rate)
        return self._bundle

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    @property
    def label(self) -> Optional[np.ndarray]:
        return self.metadata.label

    def feature_arrays(self) -> Dict[str, np.ndarray]:
        """Per-used-feature metadata arrays the split scan reads: num_bins,
        offsets, default_bins, missing_types (0 None / 1 Zero / 2 NaN) and
        is_categorical."""
        ms = [self.mappers[j] for j in self.used_features]
        return dict(
            num_bins=np.asarray(self.feature_num_bins, np.int32),
            default_bins=np.asarray([m.default_bin for m in ms], np.int32),
            missing_types=np.asarray([MISSING_CODES[m.missing_type]
                                      for m in ms], np.int32),
            is_categorical=np.asarray([m.bin_type == BIN_CATEGORICAL
                                       for m in ms], bool))
