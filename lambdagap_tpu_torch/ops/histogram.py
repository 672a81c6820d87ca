"""Histogram helpers around the leaf-histogram kernels.

The port of what the fused learner needs from
``lambdagap_tpu/ops/histogram.py``: the histogram-subtraction trick
(reference: serial_tree_learner.cpp:408-476) — the larger child's histogram
is its parent's minus the smaller child's, so each split builds only the
smaller side with :func:`~lambdagap_tpu_torch.ops.hist_cuda.hist_rows` (or
``hist_rows_q``) — and the EFB un-bundling of a histogram over bundled
columns back to per-feature space. The XLA one-hot contraction of the JAX
package (its non-Pallas path) is not ported: every histogram of the port
comes from a kernel, through :func:`leaf_histogram` in any row layout
(under ``data_residency=stream`` a loop over uploaded windows into K1's
accumulate mode, ``ops/partition.StreamRows.histogram``). Where a
quantized level sum could pass int32 (rows x ``num_grad_quant_bins`` at
``exact_accum_limit("pallas")``), each quantized histogram is K2 launches
over consecutive position windows summed exactly in int64
(:func:`_windowed_q`), where the JAX package falls back to per-chunk
scaled float32 sums (``lambdagap_tpu/models/fused_learner.py:139-151``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..data.bundling import KIND_COPY, KIND_DEFAULT
from ..infer.engine import LaunchCounter
from .hist_cuda import Count, hist_rows, hist_rows_q
from .partition import GatherRows, SortedRows, StreamRows

# the windows the windowed quantized histograms built (one K2 launch each)
QUANT_WINDOWS = LaunchCounter()


def subtract_histogram(parent_hist: torch.Tensor,
                       child_hist: torch.Tensor) -> torch.Tensor:
    """Sibling histogram = parent - child (reference: FeatureHistogram::
    Subtract, feature_histogram.hpp)."""
    return parent_hist - child_hist


def unbundle_hist(hist_b: torch.Tensor, src: torch.Tensor,
                  kind: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Expand histograms over EFB-bundled columns back to per-feature space
    (``lambdagap_tpu/ops/histogram.py:196-215``).

    hist_b: f32 ``[..., C, Bb, 3]``; src/kind: ``data.bundling.unbundle_map``
    on the device (src int64) — COPY bins gather from the flattened bundle
    histogram; a bundled feature's default bin is the leaf's residual
    ``total - sum(COPY bins)`` (the analog of FixHistogram, reference:
    feature_histogram.hpp GatherInfoForThreshold). totals: ``[..., 3]``,
    each leaf's own (grad, hess, count) sums. Returns f32 ``[..., F, B, 3]``.
    """
    lead = hist_b.shape[:-3]
    flat = hist_b.reshape(*lead, -1, hist_b.shape[-1])
    out = flat[..., src, :]                             # [..., F, B, 3]
    out = torch.where((kind == KIND_COPY)[..., None], out, 0.0)
    # in float64, so the card and the CPU agree to the bit
    nzsum = torch.sum(out, dim=-2, dtype=torch.float64).float()  # [..., F, 3]
    resid = totals[..., None, :] - nzsum
    return torch.where((kind == KIND_DEFAULT)[..., None], resid[..., None, :],
                       out)


def _windowed_q(bins, gq, hq, rows, live: Count, count: int, num_bins: int,
                mask, offset, window: int) -> torch.Tensor:
    """A quantized histogram over the first ``live`` of ``count`` positions
    from ``offset`` as K2 launches over consecutive windows of at most
    ``window`` positions (window w: offset + w * window, its share of
    ``live``), each window's exact int32 sums added into int64 — so the sum
    is exact at any row count and equal to one launch's wherever that one
    fits int32. ``live`` may be a device tensor: the windows come from the
    host ``count``, a window past ``live`` adds nothing."""
    dev = bins.device
    base = offset if offset is not None else torch.zeros(
        1, dtype=torch.int32, device=dev)
    acc = torch.zeros((bins.shape[1], num_bins, 3), dtype=torch.int64,
                      device=dev)
    for w in range(max(1, -(-count // window))):
        lo = w * window
        if isinstance(live, torch.Tensor):
            cnt = (live - lo).clamp(0, window).to(torch.int32)
        else:
            cnt = min(max(int(live) - lo, 0), window)
        acc += hist_rows_q(bins, gq, hq, rows, cnt, num_bins, mask,
                           base + lo)
        QUANT_WINDOWS.add()
    return acc


def leaf_histogram(layout: Union[GatherRows, SortedRows, StreamRows],
                   perm: torch.Tensor, begin: int, count: int,
                   num_bins: int, live: Optional[torch.Tensor] = None,
                   offset: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   q_window: Optional[int] = None) -> torch.Tensor:
    """A leaf's histogram from its kernel, in either row layout
    (``lambdagap_tpu/ops/histogram.py``'s ``leaf_histogram`` and, under
    ``tree_layout=sorted``, ``leaf_histogram_sorted``, :170-195): the leaf
    ``[begin, begin + count)`` read through its slice of the permutation
    (gather) or as a window of the leaf-ordered copies with no row list
    (sorted). f32 channels go to K1 (f32 ``[F, B, 3]``; its fixed-point
    exponents ``scale`` come from the whole dataset's gradients), int8
    levels to K2 (int32). ``live`` and ``offset`` (device tensors) pick the
    first ``live`` positions from ``offset`` on — a child inside its
    parent's slice or window; None: the whole leaf. Both layouts give the
    kernel the same rows in the same order and the sums are exact
    integers, so the histograms are equal bit for bit. Under
    ``data_residency=stream`` (:class:`StreamRows`) a child is the smaller
    child of the split just made, whose span the layout read with the
    split's go-left flags, so ``live`` and ``offset`` are not read. With
    ``q_window`` a quantized histogram is int64 sums over windows of at
    most that many positions (:func:`_windowed_q`)."""
    if isinstance(layout, StreamRows):
        if live is not None:
            begin, count = layout.child(begin, count)
        return layout.histogram(perm, begin, count, num_bins, scale)
    bins, a, b, rows, mask = layout.kernel_inputs(perm, begin, count,
                                                  live is None)
    live = count if live is None else live
    if a.dtype == torch.int8:
        if q_window is not None:
            return _windowed_q(bins, a, b, rows, live, count, num_bins, mask,
                               offset, q_window)
        return hist_rows_q(bins, a, b, rows, live, num_bins, mask, offset)
    return hist_rows(bins, a, b, rows, live, num_bins, mask, offset, scale)
