"""Histogram helpers around the leaf-histogram kernels.

The port of what the fused learner needs from
``lambdagap_tpu/ops/histogram.py``: the histogram-subtraction trick
(reference: serial_tree_learner.cpp:408-476) — the larger child's histogram
is its parent's minus the smaller child's, so each split builds only the
smaller side with :func:`~lambdagap_tpu_torch.ops.hist_cuda.hist_rows` (or
``hist_rows_q``) — and the EFB un-bundling of a histogram over bundled
columns back to per-feature space. The XLA one-hot contraction of the JAX
package (its non-Pallas path) is not ported: every histogram of the port
comes from a kernel.
"""
from __future__ import annotations

import torch

from ..data.bundling import KIND_COPY, KIND_DEFAULT


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
