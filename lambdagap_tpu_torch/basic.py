"""The user-facing ``Dataset`` and ``Booster``.

The port of ``lambdagap_tpu/basic.py`` for dense numpy data and every
objective's training flow: ``Dataset(X, label=, weight=,
group=, position=, reference=, categorical_feature=, params=)`` bins
lazily on first use (``group`` takes query sizes or per-row query ids);
``Booster(params, train_set)`` trains one iteration per ``update()``;
``Booster(params, model_file=..., model_str=...)`` loads a LightGBM v4
text model; both predict (raw, converted, ``pred_leaf``, ``pred_contrib``),
serve (``as_server``), save, dump, refit, roll back, and answer the JAX
``Booster``'s inspection calls; a Booster pickles and copies through its
model string. Entry points run on the card by default
(``device_type="cuda"``, raising where there is none);
``params={"device_type": "cpu"}`` runs every kernel's plain version on the
CPU. ``Booster.update(fobj=)`` trains on custom gradients,
``Booster.reset_parameter`` changes parameters mid-run, and a Booster is
built through ``models.dart.create_boosting`` (``boosting=gbdt|dart|rf``).
A ``Dataset`` keeps its raw matrix under ``free_raw_data=False``, which
``subset`` (cv's folds) needs; ``set_label`` / ``set_weight`` /
``set_init_score`` reach the binned dataset once it is built. A ``Sequence``
(or a list of them) is binned streamingly (``BinnedDataset.from_sequences``),
and an already-built ``ShardedBinnedDataset`` passes through to out-of-core
training; ``Booster.predict_stream`` scores out of core (``infer/stream.py``).

Data beyond a dense matrix, as in the JAX package: a data file path
(CSV / TSV / LibSVM, its sidecars, the binary cache; ``data/loader.py``)
for ``Dataset``, ``predict``, ``predict_stream``, ``eval`` and ``refit``; a
scipy sparse matrix (CSR, CSC or COO), binned a dense window of rows at a
time through ``_CSRSequence`` and predicted in windows of 65,536 rows; an
Arrow table (dictionary columns categorical) for the data and Arrow arrays
for the label, weight, group, position and init score, where pyarrow is
installed.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import Config
from .data.dataset import BinnedDataset
from .models.gbdt import GBDT
from .utils import log


def _is_arrow(data) -> bool:
    """A pyarrow object (checked by module, so pyarrow stays an optional
    import that only its own objects pull in)."""
    return type(data).__module__.split(".")[0] == "pyarrow"


def _arrow_table_to_matrix(table):
    """A pyarrow Table -> (float64 matrix, feature names, categorical
    indices), as the JAX package converts it (``lambdagap_tpu/basic.py:
    44-63``): dictionary-encoded columns become their codes and are
    categorical; boolean / integer / float columns cast to float64 with
    nulls as NaN."""
    import pyarrow as pa
    names = [str(c) for c in table.column_names]
    mat = np.empty((table.num_rows, table.num_columns), dtype=np.float64)
    categorical = []
    for i, col in enumerate(table.columns):
        if pa.types.is_dictionary(col.type):
            combined = col.combine_chunks()
            if isinstance(combined, pa.ChunkedArray):
                combined = combined.chunk(0)
            mat[:, i] = combined.indices.to_numpy(zero_copy_only=False)
            categorical.append(i)
        else:
            mat[:, i] = col.to_numpy(zero_copy_only=False)
    return mat, names, categorical


def _arrow_to_vector(arr, dtype) -> np.ndarray:
    """A pyarrow Array / ChunkedArray (or a 1- or K-column Table of init
    scores) -> numpy."""
    import pyarrow as pa
    if isinstance(arr, pa.Table):
        return np.column_stack([c.to_numpy(zero_copy_only=False)
                                for c in arr.columns]).astype(dtype)
    return arr.to_numpy(zero_copy_only=False).astype(dtype)


def _to_matrix(data) -> np.ndarray:
    """A 2-D float64 matrix from anything numpy can convert, or an Arrow
    table (the JAX package's conversion; the engines cast to float32,
    TreeSHAP decides in float64)."""
    if _is_arrow(data):
        return _arrow_table_to_matrix(data)[0]
    return np.asarray(data, dtype=np.float64)


def _is_scipy_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


class Sequence:
    """Row-batch access for streaming Dataset construction (the JAX
    package's ``Sequence``, ``lambdagap_tpu/basic.py:76``; reference:
    lightgbm.Sequence): subclass with ``__len__`` and ``__getitem__`` (a
    row slice -> numpy rows); ``batch_size`` sets how many rows a batch
    reads. The full float matrix never exists in memory."""

    batch_size = 4096

    def __getitem__(self, idx):
        raise NotImplementedError("Sequence.__getitem__")

    def __len__(self):
        raise NotImplementedError("Sequence.__len__")


class _CSRSequence(Sequence):
    """Row batches of a scipy sparse matrix (CSR, or CSC / COO through
    ``tocsr``; the JAX package's, ``lambdagap_tpu/basic.py:95-120``): each
    batch densifies one window of rows, so construction never holds the
    dense float matrix whole. 16,384 rows x 2,000 features is a 256 MB
    window."""

    batch_size = 16384

    def __init__(self, sparse) -> None:
        self.csr = sparse.tocsr()

    def __len__(self):
        return self.csr.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.csr[idx].toarray()
        return self.csr[idx:idx + 1].toarray()[0]


def _fobj_tensor(a, what: str, K: int, N: int, device):
    """A custom gradient or hessian as [K, N] float32 on the booster's
    device. Only a flat class-major array is taken: the JAX package reads
    it with ``reshape(K, -1)``, which would scramble the classes of the
    [N, K] matrix LightGBM 4 takes (ROADMAP.md, Queue 3)."""
    a = np.asarray(a, np.float32)
    if a.ndim != 1 or a.size != K * N:
        raise ValueError(
            f"fobj returned a {what} of shape {a.shape}; give a flat "
            f"class-major array of {K} x {N} = {K * N} values")
    return torch.from_numpy(np.ascontiguousarray(a.reshape(K, N))).to(device)


class Dataset:
    """Training data with lazy construction (reference: basic.py:1744
    Dataset._lazy_init). ``data`` is a dense matrix (float32 and float64
    stay as they are — binning reads them exactly — other types convert to
    float64 as the JAX package converts them), an Arrow table, a data file
    path (its sidecars loaded; a ``categorical_feature`` name resolves
    against the file's header), a scipy sparse matrix or a ``Sequence`` or
    a list of them (binned streamingly: boundaries from a sketch over every
    row), or an already-binned ``BinnedDataset`` — a
    ``ShardedBinnedDataset`` among them, which trains out of core."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.position = position
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._constructed: Optional[BinnedDataset] = None
        self.used_indices: Optional[np.ndarray] = None

    def construct(self, config: Optional[Config] = None) -> BinnedDataset:
        if self._constructed is not None:
            return self._constructed
        if isinstance(self.data, BinnedDataset):
            # an already-binned dataset (convert.dataset_from_numpy, a
            # streamingly built ShardedBinnedDataset) passes through as it
            # is, taking the label, weight and groups it lacks
            self._constructed = self.data
            md = self._constructed.metadata
            if self.label is not None and md.label is None:
                md.label = np.asarray(self.label, np.float32).reshape(-1)
            if self.weight is not None and md.weight is None:
                md.weight = np.asarray(self.weight, np.float32).reshape(-1)
            if self.group is not None and md.query_boundaries is None:
                md.set_group(np.asarray(self.group))
            md.check(self._constructed.num_data)
            return self._constructed
        cfg = config or Config.from_params(self.params)
        if not cfg.linear_tree and self.params:
            # a Dataset whose own params set linear_tree keeps its raw
            # matrix even when the booster's config lacks the flag (a
            # constant-leaf model continued from a linear init_model
            # replays the coefficients over raw rows; JAX basic.py:190-203)
            own = Config.from_params({
                k: v for k, v in self.params.items()
                if Config.canonical_name(k) == "linear_tree"})
            if own.linear_tree:
                cfg = copy.deepcopy(cfg)
                cfg.linear_tree = True
        self._arrow_metadata()
        if isinstance(self.data, (str, os.PathLike)):
            return self._construct_file(cfg, config)
        if _is_scipy_sparse(self.data):
            # binned a window of dense rows at a time (from_sequences)
            self.data = _CSRSequence(self.data)
        seqs = None
        if isinstance(self.data, Sequence):
            seqs = [self.data]
        elif (isinstance(self.data, list) and self.data
              and all(isinstance(q, Sequence) for q in self.data)):
            seqs = self.data
        names = ([str(n) for n in self.feature_name]
                 if isinstance(self.feature_name, (list, tuple)) else None)
        categorical: List[int] = []
        mat = None
        if _is_arrow(self.data):
            mat, auto_names, categorical = _arrow_table_to_matrix(self.data)
            names = names or auto_names
        if isinstance(self.categorical_feature, (list, tuple)):
            for c in self.categorical_feature:
                if isinstance(c, str) and names and c in names:
                    categorical.append(names.index(c))
                elif isinstance(c, (int, np.integer)):
                    categorical.append(int(c))
        ref = (self.reference.construct(config)
               if self.reference is not None else None)
        if seqs is not None:
            self._constructed = BinnedDataset.from_sequences(
                seqs, cfg, label=self.label, weight=self.weight,
                group=self.group, init_score=self.init_score,
                position=self.position, categorical_features=categorical,
                feature_names=names, reference=ref)
            if self.free_raw_data:
                self.data = None
            return self._constructed
        if mat is None:
            mat = np.asarray(self.data)
        if mat.dtype not in (np.float32, np.float64):
            mat = mat.astype(np.float64)
        self._constructed = BinnedDataset.from_matrix(
            mat, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, group=self.group,
            position=self.position, categorical_features=categorical,
            feature_names=names, reference=ref)
        if self.free_raw_data:
            self.data = None
        return self._constructed

    def _arrow_metadata(self) -> None:
        """Arrow label / weight / group / position / init score -> numpy,
        once, at the boundary (a K-column init-score table is class-major;
        the JAX package's ``basic.py:207-217``)."""
        for name, dtype in (("label", np.float32), ("weight", np.float32),
                            ("group", np.int64), ("position", np.int64)):
            v = getattr(self, name)
            if _is_arrow(v):
                setattr(self, name, _arrow_to_vector(v, dtype).reshape(-1))
        if _is_arrow(self.init_score):
            init = _arrow_to_vector(self.init_score, np.float64)
            self.init_score = init.T.reshape(-1) if init.ndim == 2 else init

    def _construct_file(self, cfg: Config,
                        config: Optional[Config]) -> BinnedDataset:
        """A Dataset straight from a data file (``data/loader.py``; the JAX
        package's ``basic.py:221-262``): the constructor's
        ``categorical_feature`` takes the place of the params key, names
        resolved against ``feature_name`` or else the file's header; the
        constructor's label, weight, init score and group override the
        file's."""
        from .data.loader import load_data_file
        if isinstance(self.categorical_feature, (list, tuple)):
            cfg = copy.deepcopy(cfg)
            names = (list(self.feature_name)
                     if isinstance(self.feature_name, (list, tuple)) else None)
            cats = []
            for c in self.categorical_feature:
                if isinstance(c, str):
                    cats.append(str(names.index(c)) if names and c in names
                                else f"name:{c}")
                else:
                    cats.append(str(int(c)))
            cfg.categorical_feature = ",".join(cats)
        ref = (self.reference.construct(config)
               if self.reference is not None else None)
        ds = load_data_file(str(self.data), cfg, reference=ref)
        if isinstance(self.feature_name, (list, tuple)):
            ds.feature_names = [str(n) for n in self.feature_name]
        md = ds.metadata
        if self.label is not None:
            md.label = np.asarray(self.label, np.float32).reshape(-1)
        if self.weight is not None:
            md.weight = np.asarray(self.weight, np.float32).reshape(-1)
        if self.init_score is not None:
            md.init_score = np.asarray(self.init_score,
                                       np.float64).reshape(-1)
        if self.group is not None:
            md.set_group(self.group)
        md.check(ds.num_data)
        self._constructed = ds
        if self.free_raw_data:
            self.data = None
        return ds

    def num_data(self) -> int:
        return (self._constructed.num_data if self._constructed is not None
                else np.shape(self.data)[0])

    def num_feature(self) -> int:
        return (self._constructed.num_total_features
                if self._constructed is not None else np.shape(self.data)[1])

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None, position=None
                     ) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params,
                       position=position, feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature)

    # -- the lightgbm-compatible setters (lambdagap_tpu/basic.py:326-367) --
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._constructed is not None:
            self._constructed.metadata.label = \
                np.asarray(label, np.float32).reshape(-1)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._constructed is not None and weight is not None:
            self._constructed.metadata.weight = \
                np.asarray(weight, np.float32).reshape(-1)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._constructed is not None and init_score is not None:
            self._constructed.metadata.init_score = \
                np.asarray(init_score, np.float64).reshape(-1)
        return self

    def get_weight(self):
        if self._constructed is not None:
            return self._constructed.metadata.weight
        return self.weight

    def subset(self, used_indices, params=None) -> "Dataset":
        """A row subset binned with this dataset's mappers (cv's folds).
        Like the JAX package's, it carries the label and the weight, not
        the groups, init scores or positions (ROADMAP.md, Queue 3)."""
        if self.data is None:
            log.fatal("Cannot subset: raw data freed "
                      "(set free_raw_data=False)")
        if isinstance(self.data, (BinnedDataset, Sequence)) or (
                isinstance(self.data, list) and self.data
                and isinstance(self.data[0], Sequence)):
            log.fatal("Cannot subset a %s: subset takes rows of a raw "
                      "matrix", type(self.data).__name__)
        idx = np.asarray(used_indices)
        sub = Dataset(
            np.asarray(self.data)[idx],
            label=None if self.label is None else np.asarray(self.label)[idx],
            reference=self,
            weight=None if self.weight is None
            else np.asarray(self.weight)[idx],
            feature_name=self.feature_name,
            categorical_feature=self.categorical_feature,
            params=params or self.params, free_raw_data=self.free_raw_data)
        sub.used_indices = idx
        return sub

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_group(
                None if group is None else np.asarray(group))
        return self

    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._constructed is not None and position is not None:
            self._constructed.metadata.position = \
                np.asarray(position, np.int32).reshape(-1)
        return self

    def get_label(self):
        if self._constructed is not None:
            return self._constructed.metadata.label
        return self.label

    def get_group(self):
        """Group sizes (from the boundaries once constructed)."""
        if self._constructed is not None and \
                self._constructed.metadata.query_boundaries is not None:
            return np.diff(self._constructed.metadata.query_boundaries)
        return self.group


class Booster:
    """Boosting model wrapper (reference: basic.py:3541 Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        params = params or {}
        self.params = params
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.train_set = train_set
        if train_set is not None:
            from .models.dart import create_boosting
            cfg = Config.from_params(params)
            self._booster = create_boosting(cfg, train_set.construct(cfg))
        elif model_file is not None:
            self._booster = GBDT.from_model_file(model_file,
                                                 Config.from_params(params))
        elif model_str is not None:
            self._booster = GBDT.from_model_string(model_str,
                                                   Config.from_params(params))
        else:
            log.fatal("Booster needs train_set, model_file or model_str")
        self.config = self._booster.config

    @classmethod
    def _from_gbdt(cls, gbdt: GBDT, params: Optional[Dict[str, Any]] = None
                   ) -> "Booster":
        b = cls.__new__(cls)
        b.params = dict(params or {})
        b.best_iteration = -1
        b.best_score = {}
        b.train_set = None
        b._booster = gbdt
        b.config = gbdt.config
        return b

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._booster.add_valid_set(data.construct(self.config), name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; returns True if training should stop
        (reference: basic.py:4050 Booster.update). ``fobj(preds,
        train_data)`` gives custom gradients: ``preds`` are the raw training
        scores ([N], or [N, K] for K classes), ``train_data`` the binned
        training set, and the gradient and hessian come back flat and
        class-major (K*N values, class k's at ``k*N:(k+1)*N``), as the JAX
        package reads them. Under ``guard_nonfinite`` raise / skip_tree the
        round's own scores are read before it returns, as the JAX
        package's ``update`` reads them
        (``lambdagap_tpu/guard/nonfinite.py:128-153``): a round that left
        them non-finite raises here, or is dropped
        (``last_iteration_skipped``)."""
        stop = self._step(train_set, fobj)
        if self._booster.guard_finish():
            self._booster.last_iteration_skipped = True
        return stop

    def _step(self, train_set: Optional[Dataset] = None,
              fobj=None) -> bool:
        """:meth:`update` without the guard's read of the round's scores:
        ``engine.train`` leaves that read to the next round's first record
        read and to one read when training ends, so a round gains no
        sync."""
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError(
                "Booster.update(train_set=) with another dataset is not "
                "ported to lambdagap_tpu_torch (the JAX package ignores it); "
                "train a new Booster on it")
        gb = self._booster
        if fobj is None:
            return gb.train_one_iter()
        K = gb.num_tree_per_iteration
        raw = gb.scores.cpu().numpy()
        grad, hess = fobj(raw[0] if K == 1 else raw.T, gb.train_set)
        return gb.train_one_iter(
            _fobj_tensor(grad, "grad", K, gb.num_data, gb.device),
            _fobj_tensor(hess, "hess", K, gb.num_data, gb.device))

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Update training parameters mid-run (reference:
        Booster.reset_parameter -> LGBM_BoosterResetParameter; the JAX
        package's ``basic.py:732-743``): the shared config takes them, and
        a new ``learning_rate`` becomes the shrinkage (never under RF).
        The learners copy their split parameters when they are built, in
        both packages, so a change of e.g. ``lambda_l2`` does not reach the
        trees of a running booster."""
        self.config.update(params)
        has_lr = any(Config.canonical_name(k) == "learning_rate"
                     for k in params)
        if has_lr and self.config.boosting != "rf":
            self._booster.shrinkage_rate = float(self.config.learning_rate)
        return self

    @property
    def telemetry(self):
        raise NotImplementedError(
            "Booster.telemetry is not ported to lambdagap_tpu_torch yet (the "
            "obs layer: ROADMAP.md, Queue 1 item 5)")

    def refit(self, data, label=None, weight=None, group=None,
              decay_rate: float = 0.9, **kwargs) -> "Booster":
        """Refit the existing tree structures to new data (reference:
        basic.py Booster.refit -> GBDT::RefitTree). Returns a new Booster;
        this one is unchanged. ``data`` may be a data file path, whose
        label, weight and groups stand in for the arguments left None."""
        if isinstance(data, (str, os.PathLike)):
            from .data.loader import _parse_text_file
            data, y, w, g, _ = _parse_text_file(str(data), self.config)
            label = y if label is None else label
            weight = w if weight is None else weight
            group = g if group is None else group
        new = Booster(params=self.params, model_str=self.model_to_string())
        new._booster.refit(_to_matrix(data), label, weight=weight,
                           group=group, decay_rate=decay_rate)
        return new

    def rollback_one_iter(self) -> "Booster":
        self._booster.rollback_one_iter()
        return self

    @property
    def current_iteration(self) -> int:
        return self._booster.iter_

    def eval_train(self):
        return self._booster.eval_train()

    def eval_valid(self):
        return self._booster.eval_valid()

    def eval(self, data: Dataset, name: str, feval=None):
        """Evaluate the configured metrics on a dataset (reference:
        basic.py Booster.eval). The registered training and validation
        sets use their scores; any other dataset is predicted and scored
        by the metric set; ``feval(preds, data)`` adds its
        ``(name, value, greater_is_better)`` tuples."""
        from .metrics import create_metrics
        gb = self._booster
        if data._constructed is not None:
            if data._constructed is gb.train_set:
                out = [(name, m, v, g) for (_, m, v, g) in gb.eval_train()]
                if out:
                    return out
                md = gb.train_set.metadata
                metrics = create_metrics(self.config, md,
                                         gb.train_set.num_data)
                scores = gb._converted_scores(gb.scores)
                return [(name, mn, float(v), m.greater_is_better)
                        for m in metrics for mn, v in m.eval(scores)]
            for vn, vds in gb.valid_sets:
                if vds is data._constructed:
                    return [(name, m, v, g) for (d, m, v, g)
                            in gb.eval_valid() if d == vn]
            if data.data is None:
                log.fatal("Booster.eval needs the raw data: this Dataset "
                          "was constructed and is not a registered "
                          "train/valid set")
        from .data.dataset import Metadata
        if isinstance(data.data, (str, os.PathLike)):
            from .data.loader import _parse_text_file
            X, label, weight, group, _ = _parse_text_file(str(data.data),
                                                          self.config)
        else:
            X = _to_matrix(data.data)
            label, weight, group = data.label, data.weight, data.group
        md = Metadata()
        if label is not None:
            md.label = np.asarray(label, np.float32).reshape(-1)
        if weight is not None:
            md.weight = np.asarray(weight, np.float32).reshape(-1)
        if group is not None:
            md.set_group(np.asarray(group))
        metrics = create_metrics(self.config, md, len(X))
        # metrics consume output-space scores, as the training loop hands
        # them (single-class [N], multiclass [K, N])
        raw = self.predict(X)
        scores = raw if raw.ndim == 1 else raw.T
        out = [(name, mn, float(v), m.greater_is_better)
               for m in metrics for mn, v in m.eval(scores)]
        if feval is not None:
            res = feval(np.asarray(raw), data)
            res = [res] if isinstance(res, tuple) else res
            out.extend((name, mn, float(v), gib) for mn, v, gib in res)
        return out

    # ------------------------------------------------------------------
    def num_trees(self) -> int:
        return len(self._booster.models)

    def predict(self, data, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: int = -1, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        if _is_scipy_sparse(data):
            # densify one row window at a time
            csr = data.tocsr()
            step = 65536
            return np.concatenate(
                [self.predict(csr[lo:lo + step].toarray(),
                              raw_score=raw_score,
                              start_iteration=start_iteration,
                              num_iteration=num_iteration,
                              pred_leaf=pred_leaf,
                              pred_contrib=pred_contrib, **kwargs)
                 for lo in range(0, csr.shape[0], step)], axis=0)
        if isinstance(data, (str, os.PathLike)):
            # a data file, label and dropped columns stripped (reference:
            # LGBM_BoosterPredictForFile)
            from .data.loader import _parse_text_file
            data = _parse_text_file(str(data), self.config)[0]
        mat = _to_matrix(data)
        if pred_leaf:
            return self._booster.predict_leaf(mat, start_iteration,
                                              num_iteration)
        if pred_contrib:
            return self._booster.predict_contrib(mat, start_iteration,
                                                 num_iteration)
        return self._booster.predict(mat, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration)

    def predict_stream(self, data, raw_score: bool = False,
                       start_iteration: int = 0, num_iteration: int = -1,
                       pred_contrib: bool = False, window_rows: int = 0,
                       out: Optional[np.ndarray] = None, signal_source=None,
                       stats_out: Optional[Dict[str, Any]] = None
                       ) -> np.ndarray:
        """Out-of-core batch scoring (``infer/stream.py``; the JAX
        package's ``Booster.predict_stream``): ``data`` is a dense matrix,
        an ``np.memmap``, a data file path (parsed a window at a time) or a
        ``ShardedBinnedDataset`` built with ``reference=`` this model's
        training set. Scores are bit-equal to :meth:`predict`; ``out``
        (e.g. an ``np.memmap``) receives the rows in place;
        ``signal_source`` arms the co-tenant throttle; ``stats_out``
        receives the run report."""
        from .data.stream import ShardedBinnedDataset
        if not isinstance(data, (np.ndarray, ShardedBinnedDataset,
                                 str, os.PathLike)):
            data = _to_matrix(data)
        return self._booster.predict_stream(
            data, start_iteration=start_iteration,
            num_iteration=num_iteration, raw_score=raw_score,
            pred_contrib=pred_contrib, window_rows=window_rows, out=out,
            signal_source=signal_source, stats_out=stats_out)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = None) -> "Booster":
        if importance_type is None:
            importance_type = ("gain" if getattr(
                self._booster.config, "saved_feature_importance_type", 0)
                else "split")
        it = {"split": 0, "gain": 1}.get(importance_type, 0)
        ni = -1 if num_iteration is None else num_iteration
        self._booster.save_model(filename, start_iteration, ni, it)
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0, **kwargs) -> Dict[str, Any]:
        """JSON-serializable model dict (reference: Booster.dump_model ->
        GBDT::DumpModel)."""
        from .models.model_text import dump_model
        ni = -1 if num_iteration is None else num_iteration
        return dump_model(self._booster, start_iteration, ni)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        it = {"split": 0, "gain": 1}.get(importance_type, 0)
        ni = -1 if num_iteration is None else num_iteration
        return self._booster.save_model_to_string(start_iteration, ni, it)

    def model_from_string(self, model_str: str) -> "Booster":
        """Load a model into this booster (reference:
        Booster.model_from_string)."""
        self._booster = GBDT.from_model_string(model_str, self.config)
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        from .models.model_text import feature_importance
        it = {"split": 0, "gain": 1}.get(importance_type, 0)
        return feature_importance(self._booster, it)

    def feature_name(self) -> List[str]:
        return self._booster.feature_names

    def num_feature(self) -> int:
        return len(self._booster.feature_names)

    def num_model_per_iteration(self) -> int:
        return self._booster.num_tree_per_iteration

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """(reference: LGBM_BoosterGetLeafValue)"""
        return float(self._booster._tree(tree_id).leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """(reference: LGBM_BoosterSetLeafValue); drops the predict
        caches."""
        self._booster._tree(tree_id).leaf_value[leaf_id] = float(value)
        self._booster.invalidate_predict_cache()
        return self

    def _leaf_extreme(self, fn) -> float:
        b = self._booster
        return float(sum(fn(b._tree(i).leaf_value[:max(
            b._tree(i).num_leaves, 1)]) for i in range(len(b.models))))

    def lower_bound(self) -> float:
        """Smallest possible raw prediction: the sum of each tree's
        smallest leaf value (reference: GBDT::GetLowerBoundValue)."""
        return self._leaf_extreme(np.min)

    def upper_bound(self) -> float:
        """(reference: GBDT::GetUpperBoundValue)"""
        return self._leaf_extreme(np.max)

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of the numerical split thresholds used for one feature
        (reference: basic.py Booster.get_split_value_histogram)."""
        b = self._booster
        if isinstance(feature, str):
            feature = b.feature_names.index(feature)
        vals = [t.threshold_real[k] for t in b.host_models
                for k in range(t.num_internal)
                if t.split_feature[k] == feature and not t.is_categorical[k]]
        vals = np.asarray(vals, np.float64)
        if bins is None:
            bins = max(min(len(vals), 32), 1)
        hist, edges = np.histogram(vals, bins=bins)
        if xgboost_style:
            return np.column_stack([edges[1:], hist])
        return hist, edges

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Shuffle the tree order, seeded by ``data_random_seed``
        (reference: GBDT::ShuffleModels)."""
        b = self._booster
        K = b.num_tree_per_iteration
        lo = start_iteration * K
        hi = len(b.models) if end_iteration < 0 else end_iteration * K
        seg = b.host_models[lo:hi]
        np.random.RandomState(self.config.data_random_seed).shuffle(seg)
        b.models[lo:hi] = seg
        b.invalidate_predict_cache()
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_name = name       # read by engine.train's eval loop
        return self

    def free_dataset(self) -> "Booster":
        """Kept for API compatibility: datasets are garbage-collected."""
        return self

    def free_network(self) -> "Booster":
        """Kept for API compatibility: there is no network to free."""
        return self

    def as_server(self, **kwargs) -> "ForestServer":
        """Wrap this booster in a batched inference server
        (``lambdagap_tpu_torch.serve.ForestServer``): the forest is lowered
        and uploaded to the device once, and concurrent
        ``predict``/``submit`` calls are coalesced into padded device
        batches, in a multi-model registry (``serve_hbm_budget_mb``,
        ``serve_swap_breaker``, ``serve_pack_models`` bind). A non-default
        value of a serve knob of a layer the port does not carry (request
        tracing, the serve-side profiler, the autonomics) is refused by
        name."""
        from .serve import ForestServer
        cfg = self.config
        for knob, unset in (("serve_trace_sample", 0.0),
                            ("serve_trace_out", ""),
                            ("profile_serve_start_req", -1),
                            ("serve_autonomics", False),
                            ("serve_autonomics_placement", True)):
            if getattr(cfg, knob) != unset:
                raise NotImplementedError(
                    f"{knob}={getattr(cfg, knob)!r} is not ported to "
                    "lambdagap_tpu_torch yet (ROADMAP.md, Queue 1 item 2)")
        return ForestServer(self, **kwargs)

    # pickling and copying through the model string (reference: Booster
    # __getstate__/__setstate__): the binned data and device state stay
    # behind; an unpickled booster lands on the card unless its params say
    # device_type=cpu
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_booster"] = None
        state["config"] = None
        state["train_set"] = None
        state["_pickled_model"] = self.model_to_string()
        return state

    def __setstate__(self, state):
        model_str = state.pop("_pickled_model", "")
        self.__dict__.update(state)
        self._booster = GBDT.from_model_string(
            model_str, Config.from_params(self.params))
        self.config = self._booster.config

    def __copy__(self):
        return self.__deepcopy__({})

    def __deepcopy__(self, memo):
        new = Booster.__new__(Booster)
        new.__setstate__(self.__getstate__())
        return new
