"""The binned training matrix and its metadata.

The port of the dense-numpy half of ``lambdagap_tpu/data/dataset.py``: the
reference's ``Dataset``/``Metadata`` (reference:
include/LightGBM/dataset.h:48-397; src/io/dataset.cpp) as one dense
row-major ``uint8``/``uint16`` matrix ``[num_data, num_used_features]``.
Bin finding samples rows with the same numpy ``RandomState`` draw as the
JAX package, so mappers and the binned matrix are equal to its own. The
matrix stays on the host here; the learner uploads it to its device once.

The EFB bundled matrix is built on demand
(:meth:`BinnedDataset.ensure_bundle`), as the JAX package builds it. Query
groups, positions, streamed construction and the linear-tree raw matrix
wait for later slices.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper)

MISSING_CODES = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}


@dataclass
class Metadata:
    """Labels, weights and init scores
    (reference: include/LightGBM/dataset.h:48-397)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    init_score: Optional[np.ndarray] = None          # [num_data * num_class]

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            log.fatal("Length of label (%d) != num_data (%d)",
                      len(self.label), num_data)
        if self.weight is not None and len(self.weight) != num_data:
            log.fatal("Length of weight (%d) != num_data (%d)",
                      len(self.weight), num_data)


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
        self._bundle = None
        self._bundle_built = False

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[np.ndarray] = None,
                    weight: Optional[np.ndarray] = None,
                    init_score: Optional[np.ndarray] = None,
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
            # (reference: Dataset::CreateValid, src/io/dataset.cpp)
            for k in ("mappers", "used_features", "feature_num_bins",
                      "bin_offsets", "feature_names",
                      "max_bin"):
                setattr(ds, k, getattr(reference, k))
        else:
            ds._find_bins(data, config, set(categorical_features))
        ds._push_data(data)
        md = ds.metadata
        if label is not None:
            md.label = np.asarray(label, dtype=np.float32).reshape(-1)
        if weight is not None:
            md.weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if init_score is not None:
            md.init_score = np.asarray(init_score,
                                       dtype=np.float64).reshape(-1)
        md.check(ds.num_data)
        return ds

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
        self.used_features = [j for j, m in enumerate(self.mappers)
                              if not m.is_trivial]
        if not self.used_features:
            log.fatal("Cannot construct Dataset: all features are trivial "
                      "(constant); check your input data")
        self.feature_num_bins = [self.mappers[j].num_bin
                                 for j in self.used_features]
        self.bin_offsets = [int(v) for v in np.concatenate(
            [[0], np.cumsum(self.feature_num_bins)[:-1]])]

    def _push_data(self, data: np.ndarray) -> None:
        """Bin every row, one used feature (column) at a time."""
        dtype = (np.uint8 if max(self.feature_num_bins, default=2) <= 256
                 else np.uint16)
        binned = np.empty((self.num_data, len(self.used_features)), dtype)
        for k, j in enumerate(self.used_features):
            binned[:, k] = self.mappers[j].values_to_bins(data[:, j])
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
