"""Sequence tailing: a directory of row batches as a streaming source.

The port of ``lambdagap_tpu/data/tail.py`` (the continuous-learning
loop's source; the loop layer is not ported yet). Producers land one
``.npy`` file per row batch — a 2-D float array whose column 0 is the
label and columns 1.. the features — written atomically (a temporary name
in the same directory, then ``os.replace``: :func:`write_batch`).
:class:`SequenceTail` polls the directory and returns each batch exactly
once, in filename order, so producers order batches by naming them
(``batch_000001.npy`` ...).

A file that fails to parse is not marked seen: a non-atomic writer's
half-landed file is retried at the next poll, so the tail never takes a
torn batch and never wedges on one.

Batches become :class:`~lambdagap_tpu_torch.basic.Sequence` views
(:class:`ArraySequence`) for ``Dataset`` construction through
``BinnedDataset.from_sequences``; later batches pass the first one's
dataset as ``reference=`` and keep its bin mappers.
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from ..basic import Sequence
from ..utils import log


class ArraySequence(Sequence):
    """An in-memory row batch as a streaming Sequence view."""

    def __init__(self, arr, batch_size: int = 4096) -> None:
        self.arr = np.ascontiguousarray(arr, dtype=np.float64)
        self.batch_size = int(batch_size)

    def __len__(self) -> int:
        return int(self.arr.shape[0])

    def __getitem__(self, idx):
        return self.arr[idx]


def split_batch(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One tailed batch -> (features, label): column 0 is the label."""
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError("a tailed batch must be 2-D with a label column "
                         f"plus >= 1 feature column; got shape {arr.shape}")
    return arr[:, 1:], arr[:, 0]


def write_batch(dirpath: str, name: str, X, y) -> str:
    """Land one batch file atomically (the producer half of the protocol);
    returns its final path."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1, 1)
    if X.shape[0] != y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but y has {y.shape[0]}")
    if not name.endswith(".npy"):
        name += ".npy"
    path = os.path.join(dirpath, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, np.hstack([y, X]))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class SequenceTail:
    """Polls a directory for new batch files; each valid file is returned
    exactly once, in filename order."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._seen: set = set()

    def poll(self) -> List[np.ndarray]:
        """New, fully landed batches since the last poll (may be empty)."""
        out: List[np.ndarray] = []
        for p in sorted(glob.glob(os.path.join(self.path, "*.npy"))):
            name = os.path.basename(p)
            if name in self._seen or ".tmp." in name:
                continue
            try:
                arr = np.asarray(np.load(p, allow_pickle=False),
                                 dtype=np.float64)
                if arr.ndim != 2 or arr.shape[1] < 2:
                    raise ValueError(f"bad batch shape {arr.shape}")
            except (OSError, ValueError) as e:
                # not marked seen: a half-landed file from a non-atomic
                # producer is retried at the next poll instead of lost
                log.warning("tail: skipping unreadable batch %s (%s)", p, e)
                continue
            self._seen.add(name)
            out.append(arr)
        return out
