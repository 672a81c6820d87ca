"""Forest compiler: lower a trained GBDT into a serving-shaped artifact.

A copy of ``lambdagap_tpu/infer/compile.py`` (the port imports nothing of
the JAX package). Host numpy only, so the same model under the same
``infer_*`` knobs compiles to the same buffers, the same ``to_bytes()``
and the same sha256 in either package — an artifact compiled by one
serves in the other.

Training-shaped node tables (ops/predict.py ``TreeArrays``) keep every
tree's nodes in SPLIT order and spend 4 bytes on every threshold and
feature id because training needs to keep appending; serving needs none of
that. Following the inference-accelerator literature ("Booster: An
Accelerator for Gradient Boosting Decision Trees", arXiv:2011.02022 —
quantized packed node records, breadth ordering, structural tree merging),
:func:`compile_forest` emits an artifact shaped for traversal:

- **Dead-branch pruning** — exact path-interval analysis: a node testing a
  feature an ancestor already decided (same missing semantics, implied
  threshold ordering) routes every possible input the same way, so the
  node is replaced by its taken subtree. This is the raw-value shadow of
  the bin universe: binned training reuses bin-boundary thresholds along
  deep paths, which is precisely when repeated-feature dominated tests
  appear. Pruning never changes a prediction for ANY input (missing/NaN
  included) — the parity suite holds bit-for-bit.
- **Same-structure tree merging** — trees whose pruned split structure is
  byte-identical (features, thresholds, routing flags, children, category
  bitsets) share ONE traversal; only their leaf payloads stay per-tree.
  Iteration-tiled and multi-seed-averaged forests collapse by the tile
  factor; traversal cost becomes O(unique structures), not O(trees).
- **Breadth-first node blocks** — each merged structure's nodes are
  renumbered breadth-first and packed level-major across all structures of
  a block, so one depth step of the whole block is one contiguous fetch of
  one level slab. Blocks are sized by ``infer_node_block_kb`` (sized for
  the TPU kernel's VMEM in the JAX package; the port keeps the default so
  the artifact bytes agree, and its CUDA kernel reads the node tables
  through L2 — see csrc/traverse.cu).
- **Quantized node records** — thresholds are palette-quantized: the
  artifact stores a sorted table of the forest's UNIQUE f32 thresholds and
  each node keeps only a u8/u16 code into it (``infer_quant``). Decoding
  returns the exact f32 the training-shaped tables held, so quantization
  is decision-lossless — a lossy threshold grid would break the scan-
  oracle bit-identity contract this repo tests everywhere. Feature ids
  pack to u16, routing flags (default-left, missing type, categorical) to
  one u8, category bitsets to a shared row table with u16 codes.

The artifact is **content-addressed**: :attr:`ForestArtifact.hash` is the
sha256 over the packed buffers + canonical metadata, and
:attr:`ForestArtifact.source_key` hashes the model text region + compile
options — so N replicas placing the same model can share ONE compile by
shipping artifact bytes instead of each re-lowering the forest.
:class:`ArtifactStore` is that per-replica cache; the serve cache consults
it before paying a local compile, and
:exc:`ArtifactMismatch` makes a corrupt or wrong-model artifact fail
loudly at admission — a bad artifact can never be served.

This module is deliberately host-only (numpy): compilation is a packing
problem.
"""
from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ARTIFACT_FORMAT = 1
_MAGIC = b"LGAF1\n"

# flag byte layout (one u8 per node)
FLAG_DEFAULT_LEFT = 1
FLAG_MT_SHIFT = 1              # bits 1-2: missing type (0/1/2)
FLAG_CATEGORICAL = 8


class ArtifactMismatch(ValueError):
    """An artifact's content hash or source key does not match what the
    admitting side expects — the loud fallback-to-local-compile signal."""


# ---------------------------------------------------------------------------
# artifact container
# ---------------------------------------------------------------------------
@dataclass
class ForestArtifact:
    """A compiled, serializable, content-addressed forest.

    ``buffers`` hold the packed numpy arrays (node tables block-major,
    level-major within a block; palette tables; per-tree leaf payloads in
    the ops/predict.py layout). ``meta`` holds the scalars + block
    directory. ``meta["hash"]`` is filled by :func:`compile_forest` /
    :meth:`from_bytes` and always equals :func:`content_hash` of the rest.
    """

    meta: Dict = field(default_factory=dict)
    buffers: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def hash(self) -> str:
        return self.meta["hash"]

    @property
    def source_key(self) -> str:
        return self.meta["source_key"]

    @property
    def num_trees(self) -> int:
        return int(self.meta["num_trees"])

    @property
    def nbytes(self) -> int:
        return int(sum(b.nbytes for b in self.buffers.values()))

    def content_hash(self) -> str:
        """sha256 over the packed buffers + canonical meta (excluding the
        embedded hash itself)."""
        h = hashlib.sha256()
        meta = {k: v for k, v in self.meta.items() if k != "hash"}
        h.update(json.dumps(meta, sort_keys=True, default=str).encode())
        for name in sorted(self.buffers):
            b = np.ascontiguousarray(self.buffers[name])
            h.update(name.encode())
            h.update(str(b.dtype.str).encode())
            h.update(str(b.shape).encode())
            h.update(b.tobytes())
        return h.hexdigest()

    def seal(self) -> "ForestArtifact":
        self.meta["hash"] = self.content_hash()
        return self

    def verify(self, expect_hash: Optional[str] = None) -> None:
        got = self.content_hash()
        if got != self.meta.get("hash"):
            raise ArtifactMismatch(
                f"artifact content hash {got[:16]} does not match its "
                f"embedded hash {str(self.meta.get('hash'))[:16]} — "
                "corrupt or torn artifact; falling back to local compile")
        if expect_hash is not None and got != expect_hash:
            raise ArtifactMismatch(
                f"artifact content hash {got[:16]} does not match the "
                f"expected hash {expect_hash[:16]} — refusing admission; "
                "falling back to local compile")

    # -- wire round-trip ------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize: magic + u64 header length + header JSON (meta +
        buffer directory in canonical order) + raw buffer bytes."""
        names = sorted(self.buffers)
        header = {
            "format": ARTIFACT_FORMAT,
            "meta": self.meta,
            "buffers": [{"name": n, "dtype": self.buffers[n].dtype.str,
                         "shape": list(self.buffers[n].shape)}
                        for n in names],
        }
        hb = json.dumps(header, sort_keys=True, default=str).encode()
        parts = [_MAGIC, len(hb).to_bytes(8, "big"), hb]
        for n in names:
            parts.append(np.ascontiguousarray(self.buffers[n]).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, payload: bytes,
                   expect_hash: Optional[str] = None) -> "ForestArtifact":
        """Deserialize + verify. Raises :exc:`ArtifactMismatch` on a bad
        magic, torn frame, or hash disagreement — admission is all or
        nothing, a wrong-model artifact can never enter a store."""
        if not payload.startswith(_MAGIC):
            raise ArtifactMismatch("not a compiled-forest artifact "
                                   "(bad magic)")
        off = len(_MAGIC)
        hlen = int.from_bytes(payload[off:off + 8], "big")
        off += 8
        try:
            header = json.loads(payload[off:off + hlen].decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise ArtifactMismatch(f"torn artifact header: {e}") from e
        off += hlen
        if header.get("format") != ARTIFACT_FORMAT:
            raise ArtifactMismatch(
                f"unknown artifact format {header.get('format')!r}")
        buffers: Dict[str, np.ndarray] = {}
        for spec in header["buffers"]:
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            raw = payload[off:off + n]
            if len(raw) != n:
                raise ArtifactMismatch(
                    f"torn artifact: buffer {spec['name']!r} truncated")
            buffers[spec["name"]] = np.frombuffer(raw, dtype=dt
                                                  ).reshape(shape).copy()
            off += n
        art = cls(meta=dict(header["meta"]), buffers=buffers)
        art.verify(expect_hash)
        return art


# ---------------------------------------------------------------------------
# source identity
# ---------------------------------------------------------------------------
def source_key_of(gbdt, start_iteration: int = 0, num_iteration: int = -1
                  ) -> str:
    """The identity of (model content, forest slice, compile options): two
    replicas holding byte-identical models with the same ``infer_*``
    config derive the same key, which is what lets a shipped artifact be
    admitted WITHOUT re-deriving it from the trees. The model side hashes
    the serialized tree region (serve/delta.py's base-hash precedent), so
    any leaf/structure change — including in-place refits that bump the
    generation — changes the key.

    Serializing a large forest's text costs about a second on the host, and
    every swap and re-admission of a held booster looks its artifact up by
    this key; so the tree region's hash is kept on the booster, valid while
    its generation and the very tree objects in ``models`` are the same
    (in-place edits of a tree bump the generation:
    ``GBDT.invalidate_predict_cache``)."""
    cfg = gbdt.config
    trees = tuple(gbdt.models)
    memo = getattr(gbdt, "_tree_region_sha", None)
    if memo is None or memo[0] != gbdt.generation or \
            len(memo[1]) != len(trees) or \
            any(a is not b for a, b in zip(memo[1], trees)):
        from ..serve.delta import model_text_of, split_model_text
        _header, blocks, _tail = split_model_text(model_text_of(gbdt))
        region = hashlib.sha256("".join(blocks).encode())
        # the trees are read again: lazy ones are materialized by now
        memo = (gbdt.generation, tuple(gbdt.models), region)
        gbdt._tree_region_sha = memo
    h = memo[2].copy()
    h.update(json.dumps({
        "start_iteration": int(start_iteration),
        "num_iteration": int(num_iteration),
        "quant": cfg.infer_quant,
        "merge": bool(cfg.infer_merge_trees),
        "prune": bool(cfg.infer_prune),
        "node_block_kb": int(cfg.infer_node_block_kb),
        "format": ARTIFACT_FORMAT,
    }, sort_keys=True).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# dead-branch pruning (exact)
# ---------------------------------------------------------------------------
# one kept node, children already re-indexed: new internal id >= 0 / ~leaf
_NodeRec = Tuple[int, np.float32, bool, int, bool, bytes, int, int]


def _decided(constraints: List[Tuple[bool, np.float32, bool]],
             thr: np.float32, dl: bool) -> Optional[bool]:
    """Whether every input reaching this node routes the same way, given
    the (went_left, ancestor threshold, ancestor default_left) constraints
    accumulated for this (feature, missing_type) along the path. Returns
    True (always left) / False (always right) / None (live branch).

    Left propagation: an ancestor went LEFT at t1, so the state here is
    "missing and default-left" (only possible when the ancestor defaulted
    left) or "v0 <= t1". With t >= t1 the numeric case goes left; the
    missing case follows THIS node's default — so the decision is forced
    iff the ancestor never admits missing (dl1 False) or this node also
    defaults left. Right propagation mirrors it."""
    for went_left, t1, dl1 in constraints:
        if went_left:
            if thr >= t1 and ((not dl1) or dl):
                return True
        else:
            if thr <= t1 and (dl1 or (not dl)):
                return False
    return None


def _prune_tree(tree, prune: bool) -> Tuple[List[_NodeRec], int, int]:
    """(kept nodes re-indexed, root child-encoding, pruned node count).

    Root encoding: a new internal index (>= 0) or ``~leaf`` for a tree
    whose root decision is itself dead (or a stump). Leaf indices are
    NEVER renumbered — pruning only drops traversal nodes, so the
    original per-tree leaf tables stay valid and unreachable leaves are
    simply never selected."""
    if tree.num_leaves <= 1:
        return [], ~0, 0
    nodes: List[Optional[_NodeRec]] = []
    visited = 0

    def rec(n: int, cons: Dict[Tuple[int, int],
                               List[Tuple[bool, np.float32, bool]]]) -> int:
        nonlocal visited
        while True:
            if n < 0:
                return n
            visited += 1
            feat = int(tree.split_feature[n])
            thr = np.float32(tree.threshold_real[n])
            dl = bool(tree.default_left[n])
            mt = int(tree.missing_type[n])
            cat = bool(tree.is_categorical[n])
            if prune and not cat:
                d = _decided(cons.get((feat, mt), []), thr, dl)
                if d is True:
                    n = tree.left_child[n]
                    continue
                if d is False:
                    n = tree.right_child[n]
                    continue
            my = len(nodes)
            nodes.append(None)
            bits = (np.zeros(8, np.uint32) if cat is False else
                    np.asarray(tree.cat_bitset_real[n], np.uint32))
            if cat:
                lc = rec(tree.left_child[n], cons)
                rc = rec(tree.right_child[n], cons)
            else:
                key = (feat, mt)
                base = cons.get(key, [])
                cons_l = dict(cons)
                cons_l[key] = base + [(True, thr, dl)]
                lc = rec(tree.left_child[n], cons_l)
                cons_r = dict(cons)
                cons_r[key] = base + [(False, thr, dl)]
                rc = rec(tree.right_child[n], cons_r)
            nodes[my] = (feat, thr, dl, mt, cat, bits.tobytes(), lc, rc)
            return my

    root = rec(0, {})
    kept = [n for n in nodes if n is not None]
    # visited counts every node examined on live paths; nodes hanging off
    # a decided branch were never visited — both classes are pruned
    return kept, root, tree.num_internal - len(kept)


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------
def _code_dtype(n_codes: int, quant: str, what: str):
    """Smallest palette-code dtype holding ``n_codes`` values under the
    ``infer_quant`` policy (auto widens as needed; explicit u8/u16 are a
    hard promise that errors instead of silently widening)."""
    if quant == "u8":
        if n_codes > 256:
            raise ValueError(
                f"infer_quant=u8 cannot encode {n_codes} unique {what} "
                "(max 256); use infer_quant=auto or u16")
        return np.uint8
    if quant == "u16":
        if n_codes > 65536:
            raise ValueError(
                f"infer_quant=u16 cannot encode {n_codes} unique {what} "
                "(max 65536); use infer_quant=auto")
        return np.uint16
    if n_codes <= 256:
        return np.uint8
    if n_codes <= 65536:
        return np.uint16
    return np.uint32


def compile_forest(gbdt, start_iteration: int = 0, num_iteration: int = -1
                   ) -> ForestArtifact:
    """Lower a trained booster (or a slice of it) into a
    :class:`ForestArtifact`. Reads the ``infer_*`` knobs off the
    booster's config; the result is sealed (content hash computed) and
    ready for :class:`~lambdagap_tpu_torch.infer.engine.CompiledForest` or
    the wire."""
    from ..ops.predict import forest_to_arrays
    cfg = gbdt.config
    idx = gbdt._model_slice(start_iteration, num_iteration)
    trees = [gbdt._tree(i) for i in idx]
    K = gbdt.num_tree_per_iteration
    has_linear = any(getattr(t, "is_linear", False) for t in trees)

    # leaf payloads ride the EXACT ops/predict.py stacked layout — the
    # engine's leaf gather + forest-order accumulation then reuses the
    # same tables (and ops/linear.linear_leaf_values) the tensor engine
    # consumes, which is what makes scan-oracle bit-identity structural
    # rather than numerical luck
    forest, _depth = forest_to_arrays(trees, use_inner_feature=False)
    leaf_value = np.asarray(forest.leaf_value, np.float32)

    # 1) prune, 2) merge by pruned structure
    pruned_total = 0
    group_key_to_id: Dict[bytes, int] = {}
    groups: List[Tuple[List[_NodeRec], int]] = []   # (nodes, root)
    group_of_tree = np.zeros(len(trees), np.int32)
    for ti, tree in enumerate(trees):
        nodes, root, pruned = _prune_tree(tree, bool(cfg.infer_prune))
        pruned_total += pruned
        key = hashlib.sha256(repr((root, nodes)).encode()).digest()
        if not cfg.infer_merge_trees:
            key = key + ti.to_bytes(4, "big")       # every tree its own group
        gid = group_key_to_id.get(key)
        if gid is None:
            gid = group_key_to_id[key] = len(groups)
            groups.append((nodes, root))
        group_of_tree[ti] = gid

    # palette tables: unique f32 thresholds (sorted — decode is exact),
    # unique category bitset rows (row 0 = all-zero for numeric nodes)
    thr_values = sorted({float(n[1]) for nodes, _ in groups for n in nodes
                         if not n[4]})
    thr_table = np.asarray(thr_values or [0.0], np.float32)
    thr_code_of = {v: i for i, v in enumerate(thr_table.tolist())}
    W = max([8] + [len(np.frombuffer(n[5], np.uint32))
                   for nodes, _ in groups for n in nodes])
    cat_rows: Dict[bytes, int] = {np.zeros(W, np.uint32).tobytes(): 0}
    for nodes, _ in groups:
        for n in nodes:
            if n[4]:
                row = np.zeros(W, np.uint32)
                src = np.frombuffer(n[5], np.uint32)
                row[:len(src)] = src
                cat_rows.setdefault(row.tobytes(), len(cat_rows))
    cat_table = np.stack([np.frombuffer(b, np.uint32)
                          for b in cat_rows]).reshape(len(cat_rows), W)
    thr_dt = _code_dtype(len(thr_table), cfg.infer_quant, "thresholds")
    cat_dt = _code_dtype(len(cat_rows), cfg.infer_quant, "category bitsets")
    max_feat = max([0] + [n[0] for nodes, _ in groups for n in nodes])
    feat_dt = np.uint16 if max_feat < 65536 else np.uint32

    # 3) assign groups to byte-budgeted blocks, 4) pack each block's nodes
    # breadth-first level-major (one depth step = one contiguous slab)
    node_rec_bytes = (np.dtype(feat_dt).itemsize + np.dtype(thr_dt).itemsize
                      + 1 + np.dtype(cat_dt).itemsize + 8)
    budget = max(16, int(cfg.infer_node_block_kb)) * 1024
    blocks: List[List[int]] = []    # group ids per block
    acc_nodes = 0
    for g, (nodes, _root) in enumerate(groups):
        need = max(1, len(nodes)) * node_rec_bytes
        if not blocks or (acc_nodes + need > budget and acc_nodes > 0):
            blocks.append([])
            acc_nodes = 0
        blocks[-1].append(g)
        acc_nodes += need

    feat_buf: List[int] = []
    thr_buf: List[int] = []
    flag_buf: List[int] = []
    cat_buf: List[int] = []
    left_buf: List[int] = []
    right_buf: List[int] = []
    root_arr = np.zeros(len(groups), np.int32)
    block_node_lo = [0]
    block_group_lo = [0]
    block_depth: List[int] = []
    for bg in blocks:
        # BFS depth per node of every group in the block
        orders: Dict[int, List[List[int]]] = {}   # gid -> levels
        bdepth = 0
        for g in bg:
            nodes, root = groups[g]
            levels: List[List[int]] = []
            frontier = [root] if root >= 0 else []
            while frontier:
                levels.append(frontier)
                nxt = []
                for n in frontier:
                    for c in (nodes[n][6], nodes[n][7]):
                        if c >= 0:
                            nxt.append(c)
                frontier = nxt
            orders[g] = levels
            bdepth = max(bdepth, len(levels))
        # block-local ids, level-major across the block's groups
        local: Dict[Tuple[int, int], int] = {}
        seq: List[Tuple[int, int]] = []
        for d in range(bdepth):
            for g in bg:
                for n in orders[g][d] if d < len(orders[g]) else []:
                    local[(g, n)] = len(seq)
                    seq.append((g, n))
        for g in bg:
            nodes, root = groups[g]
            root_arr[g] = local[(g, root)] if root >= 0 else root
        for g, n in seq:
            feat, thr, dl, mt, cat, bits, lc, rc = groups[g][0][n]
            feat_buf.append(feat)
            thr_buf.append(0 if cat else thr_code_of[float(thr)])
            flag_buf.append((FLAG_DEFAULT_LEFT if dl else 0)
                            | (mt << FLAG_MT_SHIFT)
                            | (FLAG_CATEGORICAL if cat else 0))
            if cat:
                row = np.zeros(W, np.uint32)
                src = np.frombuffer(bits, np.uint32)
                row[:len(src)] = src
                cat_buf.append(cat_rows[row.tobytes()])
            else:
                cat_buf.append(0)
            left_buf.append(local[(g, lc)] if lc >= 0 else lc)
            right_buf.append(local[(g, rc)] if rc >= 0 else rc)
        block_node_lo.append(len(feat_buf))
        block_group_lo.append(block_group_lo[-1] + len(bg))
        block_depth.append(bdepth)

    width = max(1, 1 + max(
        (max(t.split_feature[:t.num_internal], default=0)
         for t in trees), default=0)) if trees else 1
    buffers = {
        "node_feat": np.asarray(feat_buf, feat_dt),
        "node_thr": np.asarray(thr_buf, thr_dt),
        "node_flags": np.asarray(flag_buf, np.uint8),
        "node_cat": np.asarray(cat_buf, cat_dt),
        "node_left": np.asarray(left_buf, np.int32),
        "node_right": np.asarray(right_buf, np.int32),
        "thr_table": thr_table,
        "cat_table": cat_table,
        "root": root_arr,
        "group_of_tree": group_of_tree,
        "tree_class": np.asarray([i % K for i in idx], np.int32),
        "block_node_lo": np.asarray(block_node_lo, np.int32),
        "block_group_lo": np.asarray(block_group_lo, np.int32),
        "block_depth": np.asarray(block_depth, np.int32),
        "leaf_value": leaf_value,
    }
    if has_linear:
        buffers["leaf_const"] = np.asarray(forest.leaf_const, np.float32)
        buffers["leaf_feat"] = np.asarray(forest.leaf_feat, np.int32)
        buffers["leaf_coeff"] = np.asarray(forest.leaf_coeff, np.float32)
    meta = {
        "format": ARTIFACT_FORMAT,
        "num_class": int(K),
        "num_trees": len(trees),
        "num_groups": len(groups),
        "num_blocks": len(blocks),
        "width": int(width),
        "has_linear": bool(has_linear),
        "nodes_pruned": int(pruned_total),
        "trees_merged": int(len(trees) - len(groups)),
        "thr_bits": int(np.dtype(thr_dt).itemsize * 8),
        "cat_words": int(W),
        "source_key": source_key_of(gbdt, start_iteration, num_iteration),
    }
    return ForestArtifact(meta=meta, buffers=buffers).seal()


# ---------------------------------------------------------------------------
# content-addressed store
# ---------------------------------------------------------------------------
class ArtifactStore:
    """Per-replica cache of compiled forests, keyed by source key and
    secondarily addressable by content hash.

    The serve cache consults it before paying a local compile
    (:meth:`get`), a local compile publishes into it (:meth:`put`), and a
    fleet peer ships bytes into it (:meth:`admit_bytes` — the hash-verified
    admission path of the ``artifact`` wire op). Admission is strict:
    any hash disagreement raises :exc:`ArtifactMismatch` and leaves the
    store untouched, so the worst outcome of a bad push is the local
    compile that would have happened anyway — never a wrong-model serve.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_source: Dict[str, ForestArtifact] = {}
        self._by_hash: Dict[str, str] = {}       # hash -> source_key

    def get(self, source_key: str) -> Optional[ForestArtifact]:
        with self._lock:
            return self._by_source.get(source_key)

    def get_by_hash(self, artifact_hash: str) -> Optional[ForestArtifact]:
        with self._lock:
            sk = self._by_hash.get(artifact_hash)
            return self._by_source.get(sk) if sk is not None else None

    def put(self, artifact: ForestArtifact) -> None:
        with self._lock:
            self._by_source[artifact.source_key] = artifact
            self._by_hash[artifact.hash] = artifact.source_key

    def admit_bytes(self, payload: bytes,
                    expect_hash: Optional[str] = None) -> ForestArtifact:
        """Verify + admit a serialized artifact shipped by a peer.
        Verification happens BEFORE any store mutation."""
        art = ForestArtifact.from_bytes(payload, expect_hash=expect_hash)
        self.put(art)
        return art

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_source)

    def hashes(self) -> List[str]:
        with self._lock:
            return sorted(self._by_hash)
