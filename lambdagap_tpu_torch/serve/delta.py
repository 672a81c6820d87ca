"""Delta hot-swap: ship only appended trees over the wire.

A copy of ``lambdagap_tpu/serve/delta.py`` (the port imports nothing of
the JAX package). A continuously trained booster grows by appending
trees; every already-deployed tree block is byte-identical between
generations, so a delta is a pure text splice of the line-oriented,
tree-bucketed model text (``Tree=N`` blocks between the header and the
``end of trees`` marker):

- :func:`make_delta` compares base and new text and returns a wire-safe
  dict — the new header, the APPENDED tree blocks only, the new tail, and
  a hash of the base's tree region so a stale replica can never splice
  onto the wrong foundation. Returns ``None`` when the new model does not
  extend the base (the caller falls back to a full swap).
- :func:`apply_delta` reconstructs the full new model text on the replica
  from its OWN resident base text + the delta, verifying tree count and
  hash first (:class:`DeltaMismatch` on any disagreement).

The model text is the interchange: a frame made by either package applies
to the other's resident text. The reconstructed text then takes the
normal swap path (``serve/registry.py``), circuit breaker included.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

DELTA_FORMAT = 1
_END = "end of trees"


class DeltaMismatch(ValueError):
    """The delta's base does not match the replica's resident model."""


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


def _tree_hash(blocks: List[str]) -> str:
    return hashlib.sha256("".join(blocks).encode("utf-8")).hexdigest()


def make_delta(base_text: str, new_text: str) -> Optional[Dict]:
    """The wire delta from ``base_text`` to ``new_text``, or None when
    the new model is not a pure tree-append extension of the base (tree
    count shrank, or any shared tree block changed bytes)."""
    _base_header, base_blocks, _base_tail = split_model_text(base_text)
    new_header, new_blocks, new_tail = split_model_text(new_text)
    n = len(base_blocks)
    if len(new_blocks) < n or new_blocks[:n] != base_blocks:
        return None
    return {
        "format": DELTA_FORMAT,
        "base_trees": n,
        "base_hash": _tree_hash(base_blocks),
        "append": "".join(new_blocks[n:]),
        "header": new_header,
        "tail": new_tail,
    }


def apply_delta(base_text: str, delta: Dict) -> str:
    """Reconstruct the full new model text from the replica's resident
    base text + a :func:`make_delta` frame. Raises :class:`DeltaMismatch`
    when the replica's base is not the delta's base — the registry's
    ``swap_delta`` turns that into the breaker-fed ``SwapFailed``."""
    if not isinstance(delta, dict) or delta.get("format") != DELTA_FORMAT:
        got = (delta.get("format") if isinstance(delta, dict)
               else type(delta).__name__)
        raise DeltaMismatch(f"unknown delta format {got!r}")
    for key in ("base_trees", "base_hash", "append", "header", "tail"):
        if key not in delta:
            raise DeltaMismatch(f"delta frame missing {key!r}")
    _header, blocks, _tail = split_model_text(base_text)
    n = int(delta["base_trees"])
    if len(blocks) != n:
        raise DeltaMismatch(
            f"delta expects a {n}-tree base but the resident model has "
            f"{len(blocks)} trees (a swap landed since the delta was "
            "computed); re-sync with a full swap")
    if _tree_hash(blocks) != delta["base_hash"]:
        raise DeltaMismatch(
            "delta base hash mismatch: the resident trees are not the "
            "base this delta was computed against; re-sync with a full "
            "swap")
    return (str(delta["header"]) + "".join(blocks) + str(delta["append"])
            + _END + str(delta["tail"]))


def delta_bytes(delta: Dict) -> int:
    """Wire payload size of a delta frame (what is compared against the
    full model text's bytes)."""
    return sum(len(str(delta.get(k, "")).encode("utf-8"))
               for k in ("append", "header", "tail"))


def model_text_of(gbdt) -> str:
    """The full model text of a loaded booster — the base a publisher
    diffs rollouts against (same serializer as ``GBDT.save_model``)."""
    from ..models.model_text import save_model_to_string
    return save_model_to_string(gbdt)
