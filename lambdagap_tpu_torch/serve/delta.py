"""Model-text splicing helpers.

The two pieces of ``lambdagap_tpu/serve/delta.py`` that the compiled
artifact's :func:`~lambdagap_tpu_torch.infer.compile.source_key_of` needs.
Delta hot-swap itself (``make_delta`` / ``apply_delta``) waits for the
registry and hot-swap slice.
"""
from __future__ import annotations

from typing import List, Tuple

_END = "end of trees"


def split_model_text(text: str) -> Tuple[str, List[str], str]:
    """``(header, tree_blocks, tail)`` such that
    ``header + "".join(tree_blocks) + "end of trees" + tail`` equals
    ``text`` byte-for-byte. Each block keeps its ``Tree=N`` prefix."""
    if _END not in text:
        raise ValueError("model text has no 'end of trees' marker")
    head, tail = text.split(_END, 1)
    parts = head.split("Tree=")
    header = parts[0]
    blocks = [f"Tree={p}" for p in parts[1:]]
    return header, blocks, tail


def model_text_of(gbdt) -> str:
    """The full model text of a loaded booster (same serializer as
    ``GBDT.save_model``)."""
    from ..models.model_text import save_model_to_string
    return save_model_to_string(gbdt)
