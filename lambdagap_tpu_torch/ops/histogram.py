"""Histogram helpers around the leaf-histogram kernel.

The port of what the fused learner needs from
``lambdagap_tpu/ops/histogram.py``: the histogram-subtraction trick
(reference: serial_tree_learner.cpp:408-476) — the larger child's histogram
is its parent's minus the smaller child's, so each split builds only the
smaller side with :func:`~lambdagap_tpu_torch.ops.hist_cuda.hist_rows`.
The XLA one-hot contraction of the JAX package (its non-Pallas path) is
not ported: every histogram of the port comes from the kernel.
"""
from __future__ import annotations

import torch


def subtract_histogram(parent_hist: torch.Tensor,
                       child_hist: torch.Tensor) -> torch.Tensor:
    """Sibling histogram = parent - child (reference: FeatureHistogram::
    Subtract, feature_histogram.hpp)."""
    return parent_hist - child_hist
