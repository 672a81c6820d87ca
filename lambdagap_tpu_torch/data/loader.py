"""Text and binary dataset loading.

The port of ``lambdagap_tpu/data/loader.py`` (reference:
src/io/dataset_loader.cpp — LoadFromFile :203 with auto-detected
CSV / TSV / LibSVM parsers, label / weight / group / ignored columns, the
``<file>.weight`` / ``.query`` / ``.group`` / ``.init`` / ``.position``
sidecars, two-round loading, and the binary dataset cache LoadFromBinFile
:417 / SaveBinaryFile).

Parsing stays on the host. The JAX package parses in host C++
(``lambdagap_tpu/native/parser.cpp``); the port parses with vectorised
numpy over whole blocks of lines (:func:`_parse_delim`,
:class:`_SvmBlock`), with the C++ parser's rules: an ``na`` / ``nan``
token (any case) and ``inf`` read as NaN and infinity; a non-numeric
delimited field, an empty last one and a missing one read as NaN, an
empty field inside a line as 0.0 (:func:`_field`); a LibSVM token that is
neither ``<idx>:<value>`` nor ``qid:<id>`` is fatal. Both parsers round
each decimal correctly, so the values are the same. Lines that are blank
or start with ``#`` are skipped in every format.

Every row block is binned on the config's device by kernel B
(``BinnedDataset._bin_block``): the two-round pass 2 bins each 65,536-row
chunk as it is parsed. The binary cache is the JAX package's npz layout
and magic; :func:`load_binary` reads a JAX-written file without importing
the JAX package (its pickled mappers map onto this package's
``BinMapper``, and no other global is accepted).
"""
from __future__ import annotations

import io
import itertools
import os
import pickle
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log
from ..utils.device import resolve_device
from .binning import BinMapper, QuantileSketch
from .dataset import BinnedDataset, _mappers_from_sketches, bin_dtype

BINARY_MAGIC = "lambdagap_tpu.binned.v1"
# rows a parse / bin chunk holds (the JAX package's two-round chunk)
CHUNK_ROWS = 65536
# bytes a pass-1 read holds
_READ_BYTES = 64 << 20
# chunks parsed at once: numpy releases the GIL in a LibSVM chunk's array
# work, so threads parse several (3x on 8 cores); at most this many chunks
# are in memory beyond the one being consumed
_WORKERS = min(8, os.cpu_count() or 1)
_NUMERIC_PREFIX = re.compile(
    rb"[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)",
    re.IGNORECASE)


# ---------------------------------------------------------------------------
# tokens -> float64 (the C++ parser's parse_double)
# ---------------------------------------------------------------------------
def _strtod(tok: bytes) -> Optional[float]:
    """The C++ parser's ``parse_double`` on one token: leading spaces and
    tabs skipped, an ``na`` prefix (any case) NaN, else strtod's longest
    decimal prefix; None when nothing converts."""
    s = tok.lstrip(b" \t")
    if s[:2].lower() == b"na":
        return float("nan")
    m = _NUMERIC_PREFIX.match(s.lstrip())
    return float(m.group(0)) if m else None


def _field(tok: bytes, last: bool) -> float:
    """A delimited field as ``lg_parse_delim`` reads it
    (``native/parser.cpp:183-190``): a field that converts nothing is NaN
    when the parser's pointer stayed on it and it is not an empty field
    before a delimiter — so an empty field inside a line reads 0.0, an
    empty last field or a non-numeric one NaN, and one whose leading
    spaces were skipped 0.0."""
    v = _strtod(tok)
    if v is not None:
        return v
    skipped = len(tok.lstrip(b" \t")) != len(tok)
    return 0.0 if skipped or (tok == b"" and not last) else float("nan")


def _atof(tokens: np.ndarray, what: str) -> np.ndarray:
    """LibSVM tokens (``what``: the label or a value) -> float64. numpy
    converts clean tokens in one cast; otherwise each distinct token goes
    through :func:`_strtod`, and one that converts nothing is fatal."""
    try:
        return tokens.astype(np.float64)
    except ValueError:
        pass
    uniq, inv = np.unique(tokens, return_inverse=True)
    vals = np.empty(len(uniq), np.float64)
    for i, u in enumerate(uniq.tolist()):
        v = _strtod(u)
        if v is None:
            log.fatal("LibSVM format error: %s %r is not a number", what, u)
        vals[i] = v
    return vals[inv.reshape(tokens.shape)]


def _fields(tokens: np.ndarray, last: np.ndarray) -> np.ndarray:
    """Delimited fields -> float64 by :func:`_field`; ``last`` marks each
    line's last field."""
    try:
        return tokens.astype(np.float64)
    except ValueError:
        pass
    uniq, inv = np.unique(tokens, return_inverse=True)
    inv = inv.reshape(tokens.shape)
    words = uniq.tolist()
    mid = np.asarray([_field(u, False) for u in words], np.float64)
    end = np.asarray([_field(u, True) for u in words], np.float64)
    return np.where(last, end[inv], mid[inv])


def _in_order(fn: Callable, items: Iterable):
    """``fn`` of each item, yielded in order, computed on a thread pool
    with at most ``_WORKERS`` items in flight."""
    it = iter(items)
    with ThreadPoolExecutor(_WORKERS) as pool:
        pending = deque(pool.submit(fn, x)
                        for x in itertools.islice(it, _WORKERS))
        while pending:
            done = pending.popleft().result()
            for x in itertools.islice(it, 1):
                pending.append(pool.submit(fn, x))
            yield done


def _data_lines(blob: bytes) -> List[bytes]:
    """The data lines of a block of whole lines: blank lines and ``#``
    lines dropped."""
    return [ln for ln in blob.split(b"\n")
            if ln.strip() and not ln.lstrip().startswith(b"#")]


def _parse_delim(lines: List[bytes], delim: bytes, ncols: int) -> np.ndarray:
    """Data lines of a CSV / TSV -> float64 ``[n, ncols]`` as the C++
    parser reads them (``native/parser.cpp:170-196``): fields past
    ``ncols`` are ignored and a missing one is NaN (:func:`_field` for the
    others)."""
    n = len(lines)
    if n == 0:
        return np.empty((0, ncols), np.float64)
    try:
        # numpy's C reader takes clean, rectangular blocks in one call
        M = np.loadtxt(io.BytesIO(b"\n".join(lines)), delimiter=delim.decode(),
                       comments=None, dtype=np.float64, ndmin=2)
        if M.shape == (n, ncols):
            return M
    except ValueError:
        pass
    counts = np.fromiter((ln.count(delim) + 1 for ln in lines), np.int64, n)
    if (counts == ncols).all():
        toks = np.array(delim.join(lines).split(delim)).reshape(n, ncols)
        last = np.zeros((n, ncols), bool)
        last[:, -1] = True
    else:
        rows, last = [], np.zeros((n, ncols), bool)
        for i, ln in enumerate(lines):
            f = ln.split(delim)
            if len(f) <= ncols:
                last[i, len(f) - 1] = True
            # a field the line lacks reads as NaN
            rows.append(f[:ncols] + [b"nan"] * (ncols - len(f)))
        toks = np.array(rows)
    return _fields(toks, last)


# bytes the C++ parser's strtol / strtod and ``bytes.split()`` skip
_WS = np.zeros(256, bool)
_WS[[9, 10, 11, 12, 13, 32]] = True


def _gather(u8: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Byte ranges ``[lo, hi)`` of ``u8`` as a zero-padded u8 matrix
    ``[T, widest]``, one column at a time."""
    W = max(int((hi - lo).max()), 1) if len(lo) else 1
    G = np.zeros((len(lo), W), np.uint8)
    last = len(u8) - 1
    for j in range(W):
        pos = lo + j
        G[:, j] = np.where(pos < hi, u8[np.minimum(pos, last)], 0)
    return G


# 10^k, exact in float64 for k <= 22
_POW10 = 10.0 ** np.arange(23)


def _numbers(G: np.ndarray, what: str, integer: bool = False) -> np.ndarray:
    """Tokens (u8 ``[T, W]``, zero-padded) -> float64 (or int64 with
    ``integer``) as strtod / strtol read whole tokens. Plain tokens
    ([+-]digits[.digits], at most 15 significant digits; integers up to 18
    digits, no dot) take an exact column-wise path: the mantissa m < 2^53
    and 10^f (f <= 22) are exact doubles, so m / 10^f is the correctly
    rounded decimal, strtod's. Other numbers go through numpy's cast and
    :func:`_atof`; a token that is no number (no integer with
    ``integer``) is fatal, naming ``what``."""
    T, W = G.shape
    m = np.zeros(T, np.int64)
    nd = np.zeros(T, np.int16)
    frac = np.zeros(T, np.int16)
    dotted = np.zeros(T, bool)
    c0 = G[:, 0]
    neg = c0 == ord("-")
    ok = np.ones(T, bool)
    for j in range(W):
        c = G[:, j]
        dig = (c >= 48) & (c <= 57)
        dot = c == ord(".")
        sign = (neg | (c0 == ord("+"))) if j == 0 else False
        ok &= dig | dot | (c == 0) | sign
        ok &= ~(dot & (dotted | integer))
        m = np.where(dig, m * 10 + (c.astype(np.int64) - 48), m)
        nd += dig
        frac += dig & dotted
        dotted |= dot
    ok &= (nd >= 1) & (nd <= (18 if integer else 15))
    if integer:
        if not ok.all():
            log.fatal("LibSVM format error: %s %r is not an integer", what,
                      bytes(G[np.flatnonzero(~ok)[0]]).rstrip(b"\0"))
        return np.where(neg, -m, m)
    val = m / _POW10[np.minimum(frac, 22)]
    out = np.where(neg, -val, val)
    slow = np.flatnonzero(~ok)
    if len(slow):
        out[slow] = _atof(np.ascontiguousarray(G[slow]).view(
            f"S{W}").ravel(), what)
    return out


class _SvmBlock:
    """Data lines of a LibSVM file in coordinate form: ``label`` [n],
    ``qid`` [n] (-1 where a line has none), and entries (``row``, ``col``,
    ``val``); ``max_col`` the largest feature index (-1: none). The lines
    are tokenized over their bytes at once (no Python object a token), and
    each part converts in one numpy cast."""

    def __init__(self, lines: List[bytes]) -> None:
        n = self.n = len(lines)
        self.qid = np.full(n, -1, np.int64)
        self.label = np.empty(0, np.float64)
        self.row = self.col = np.empty(0, np.int64)
        self.val = np.empty(0, np.float64)
        self.max_col = -1
        if not n:
            return
        u8 = np.frombuffer(b"\n".join(lines) + b"\n", np.uint8)
        ws = _WS[u8]
        edge = np.ones(len(u8) + 1, bool)
        edge[1:-1] = ws[1:] != ws[:-1]
        at = np.flatnonzero(edge[:-1] & ~ws)                 # token starts
        hi = np.flatnonzero(edge[1:] & ~ws) + 1              # token ends
        row_of = np.searchsorted(np.flatnonzero(u8 == 10), at)
        first = np.ones(len(at), bool)
        first[1:] = row_of[1:] != row_of[:-1]
        colons = np.flatnonzero(u8 == ord(":"))
        if not len(colons):
            colons = np.asarray([len(u8)])
        ci = np.searchsorted(colons, at)
        c = colons[np.minimum(ci, len(colons) - 1)]
        has = (c < hi)
        two = has & (colons[np.minimum(ci + 1, len(colons) - 1)] < hi) & \
            (ci + 1 < len(colons))
        feat = ~first
        bad = (first & has) | (feat & (~has | two | (c == at)))
        if bad.any():
            log.fatal("LibSVM format error: line %r: a token is neither "
                      "'<idx>:<value>' nor 'qid:<id>'",
                      lines[int(row_of[np.flatnonzero(bad)[0]])][:80])
        self.label = _numbers(_gather(u8, at[first], hi[first]), "label")
        k_lo, k_hi, rows = at[feat], c[feat], row_of[feat]
        keys = _gather(u8, k_lo, k_hi)
        is_qid = (k_hi - k_lo == 3) & ((keys[:, :3] | 0x20) == np.frombuffer(
            b"qid", np.uint8)).all(axis=1) if keys.shape[1] >= 3 else \
            np.zeros(len(k_lo), bool)
        v_lo, v_hi = k_hi + 1, hi[feat]
        if is_qid.any():
            self.qid[rows[is_qid]] = _numbers(
                _gather(u8, v_lo[is_qid], v_hi[is_qid]), "qid", integer=True)
            keep = ~is_qid
            keys, v_lo, v_hi, rows = keys[keep], v_lo[keep], v_hi[keep], \
                rows[keep]
        self.col = _numbers(keys, "feature index", integer=True)
        self.row = rows
        self.val = _numbers(_gather(u8, v_lo, v_hi), "value")
        self.max_col = int(self.col.max()) if len(self.col) else -1

    def dense(self, width: int) -> np.ndarray:
        """float64 ``[n, width]``: absent features 0, indices outside
        ``[0, width)`` dropped (a later duplicate of an index wins)."""
        X = np.zeros((self.n, max(width, 1)), np.float64)
        keep = (self.col >= 0) & (self.col < X.shape[1])
        X[self.row[keep], self.col[keep]] = self.val[keep]
        return X


def detect_format(path: str) -> str:
    """Sniff CSV vs TSV vs LibSVM from the first data line (reference:
    parser.cpp auto-detection; the JAX package's rule)."""
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.replace("\t", " ").split()
            if any(":" in t for t in tokens[1:]):
                return "libsvm"
            if "\t" in line:
                return "tsv"
            return "csv"
    return "csv"


def _read_blob(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        log.fatal("Cannot open data file %s", path)


def _load_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray]]:
    """(X, label, per-row qid or None) of a whole LibSVM file; LETOR
    ``qid:N`` tokens become query ids, any other malformed token is fatal
    (the reference Log::Fatal's on LibSVM format errors)."""
    lines = _data_lines(_read_blob(path))
    blocks = list(_in_order(_SvmBlock, (
        lines[lo:lo + CHUNK_ROWS] for lo in range(0, len(lines),
                                                  CHUNK_ROWS))))
    width = max((b.max_col for b in blocks), default=-1) + 1
    X = np.concatenate([b.dense(width) for b in blocks]) if blocks else \
        np.zeros((0, 1))
    y = np.concatenate([b.label for b in blocks]) if blocks else \
        np.empty(0)
    qid = np.concatenate([b.qid for b in blocks]) if blocks else \
        np.empty(0, np.int64)
    return X, y, (qid if (qid >= 0).any() else None)


def _load_delim(path: str, delim: str, header: bool) -> np.ndarray:
    """A whole CSV / TSV as float64; the column count is the first data
    line's."""
    lines = _data_lines(_read_blob(path))
    if header and lines:
        lines = lines[1:]
    if not lines:
        return np.empty((0, 0), np.float64)
    d = delim.encode()
    ncols = lines[0].count(d) + 1
    return np.concatenate([_parse_delim(lines[lo:lo + CHUNK_ROWS], d, ncols)
                           for lo in range(0, len(lines), CHUNK_ROWS)])


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """``name:<col>`` or an integer index (reference: config label_column)."""
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names and name in header_names:
            return header_names.index(name)
        log.fatal("Column name %s not found in header", name)
    return int(spec)


def _rows_to_sizes(per_row: np.ndarray) -> np.ndarray:
    """Per-row query ids -> run-length sizes."""
    change = np.nonzero(np.diff(per_row))[0] + 1
    bounds = np.concatenate([[0], change, [len(per_row)]])
    return np.diff(bounds)


def _header_names(path: str, delim: str) -> List[str]:
    with open(path) as f:
        return f.readline().strip().split(delim)


def _columns(config: Config, header_names: Optional[List[str]]
             ) -> Tuple[int, Optional[int], Optional[int], set]:
    """(label, weight or None, group or None, every dropped column) of a
    delimited file."""
    label_col = (_parse_column_spec(config.label_column, header_names)
                 if config.label_column else 0)
    drop = {label_col}
    weight_col = group_col = None
    if config.weight_column:
        weight_col = _parse_column_spec(config.weight_column, header_names)
        drop.add(weight_col)
    if config.group_column:
        group_col = _parse_column_spec(config.group_column, header_names)
        drop.add(group_col)
    if config.ignore_column:
        for spec in config.ignore_column.split(","):
            if spec.strip():
                drop.add(_parse_column_spec(spec.strip(), header_names))
    return label_col, weight_col, group_col, drop


def _kept_names(header_names, keep) -> Optional[List[str]]:
    """The header names of the kept columns (a short header still names
    every kept column)."""
    if not header_names:
        return None
    return [header_names[j] if j < len(header_names) else f"Column_{i}"
            for i, j in enumerate(keep)]


def _load_sidecar(path: str, suffix: str, dtype) -> Optional[np.ndarray]:
    p = path + suffix
    return np.loadtxt(p, dtype=dtype).reshape(-1) if os.path.exists(p) \
        else None


def _parse_text_file(path: str, config: Config):
    """Shared column handling for every text-ingest path (train, refit,
    predict). Returns (X, label, weight or None, group sizes or None,
    feature names or None) — the names are the header's for the kept
    columns (reference: DatasetLoader::SetHeader)."""
    fmt = detect_format(path)
    weight = group = feature_names = None
    if fmt == "libsvm":
        X, y, qid = _load_libsvm(path)
        if qid is not None:
            if (qid < 0).any():
                log.fatal("LibSVM file %s mixes rows with and without "
                          "'qid:' tokens; every row needs one", path)
            group = _rows_to_sizes(qid)
    else:
        delim = "," if fmt == "csv" else "\t"
        header_names = _header_names(path, delim) if config.header else None
        M = _load_delim(path, delim, config.header)
        label_col, wc, gc, drop = _columns(config, header_names)
        if wc is not None:
            weight = M[:, wc]
        if gc is not None:
            group = _rows_to_sizes(M[:, gc].astype(np.int64))
        y = M[:, label_col]
        keep = [j for j in range(M.shape[1]) if j not in drop]
        X = M[:, keep]
        feature_names = _kept_names(header_names, keep)
    # sidecars (reference: Metadata::LoadWeights / LoadQueryBoundaries)
    if weight is None:
        weight = _load_sidecar(path, ".weight", np.float64)
    for suffix in (".query", ".group"):
        q = _load_sidecar(path, suffix, np.int64)
        if q is not None:
            group = q
            break
    return X, y, weight, group, feature_names


# ---------------------------------------------------------------------------
# block-wise reading: pass 1's line index, chunked parses
# ---------------------------------------------------------------------------
class _TextFile:
    """A text data file read block-wise: pass 1 indexes the byte offset of
    every data line, then any range of data lines parses alone, with the
    column handling of :func:`_parse_text_file`."""

    def __init__(self, path: str, config: Config) -> None:
        self.path = path
        self.fmt = detect_format(path)
        self.delim = "," if self.fmt == "csv" else "\t"
        self.header_names: Optional[List[str]] = None
        starts: List[np.ndarray] = []
        ends: List[np.ndarray] = []
        skip_header = config.header and self.fmt != "libsvm"
        try:
            f = open(path, "rb")
        except OSError:
            log.fatal("Cannot open data file %s", path)
        with f:
            base = 0
            carry = b""
            while True:
                chunk = f.read(_READ_BYTES)
                blob = carry + chunk
                if not chunk:
                    cut = len(blob)
                else:
                    cut = blob.rfind(b"\n") + 1
                    if cut == 0:
                        carry = blob
                        continue
                seg = blob[:cut]
                lines = seg.split(b"\n")
                if not seg or seg.endswith(b"\n"):
                    lines.pop()             # the piece past the last newline
                lens = np.fromiter(map(len, lines), np.int64, len(lines))
                at = base + np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
                data = np.fromiter(
                    (bool(ln.strip()) and not ln.lstrip().startswith(b"#")
                     for ln in lines), bool, len(lines))
                starts.append(at[data])
                ends.append((at + lens)[data])
                base += cut
                carry = blob[cut:]
                if not chunk:
                    break
        self.start = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        self.end = np.concatenate(ends) if ends else np.zeros(0, np.int64)
        if skip_header and len(self.start):
            with open(path, "rb") as f:
                f.seek(self.start[0])
                self.header_names = f.read(
                    int(self.end[0] - self.start[0])).decode().strip().split(
                        self.delim)
            self.start, self.end = self.start[1:], self.end[1:]
        self.n = len(self.start)
        self.ncols = 0
        self.keep: List[int] = []       # a delimited file's kept columns
        if self.fmt != "libsvm" and self.n:
            self.ncols = self.lines(0, 1)[0].count(self.delim.encode()) + 1
            (self.label_col, self.weight_col, self.group_col,
             drop) = _columns(config, self.header_names)
            self.keep = [j for j in range(self.ncols) if j not in drop]

    def lines(self, lo: int, hi: int) -> List[bytes]:
        """Data lines ``[lo, hi)`` as bytes (the line index's, one read)."""
        if hi <= lo:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.start[lo])
            blob = f.read(int(self.end[hi - 1] - self.start[lo]))
        base = self.start[lo]
        return [blob[a - base:b - base] for a, b in
                zip(self.start[lo:hi].tolist(), self.end[lo:hi].tolist())]

    def parse(self, lo: int, hi: int):
        """Rows ``[lo, hi)``: a delimited file's (X of the kept columns,
        label, weight or None, group ids or None), or a LibSVM file's
        :class:`_SvmBlock`."""
        lines = self.lines(lo, hi)
        if self.fmt == "libsvm":
            return _SvmBlock(lines)
        M = _parse_delim(lines, self.delim.encode(), self.ncols)
        w = M[:, self.weight_col] if self.weight_col is not None else None
        q = (M[:, self.group_col].astype(np.int64)
             if self.group_col is not None else None)
        return M[:, self.keep], M[:, self.label_col], w, q

    def chunks(self, rows: int = CHUNK_ROWS):
        """Every ``rows``-row chunk's :meth:`parse`, in order (parsed on
        :func:`_in_order`'s threads)."""
        return _in_order(lambda lo: self.parse(lo, min(lo + rows, self.n)),
                         range(0, self.n, rows))

    def libsvm_width(self) -> int:
        """Max feature index + 1 over the whole file (one parse pass)."""
        return max((part.max_col for part in self.chunks()),
                   default=-1) + 1


def _libsvm_predict_width(path: str) -> int:
    """Max feature index + 1 over the WHOLE file, so block-wise LibSVM
    prediction yields the width the whole-file parse gives."""
    return _TextFile(path, Config()).libsvm_width()


class PredictFile:
    """A text data file as prediction blocks: ``n_rows`` x ``n_cols``
    (known after pass 1, and for LibSVM a whole-file width pass), then
    :meth:`blocks` in file order."""

    def __init__(self, path: str, config: Config) -> None:
        self.tf = _TextFile(path, config)
        self.svm = self.tf.fmt == "libsvm"
        self.width = self.tf.libsvm_width() if self.svm else 0
        self.n_rows = self.tf.n
        self.n_cols = max(self.width, 1) if self.svm else \
            len(self.tf.keep)

    def blocks(self, block_rows: int):
        for part in self.tf.chunks(block_rows):
            yield part.dense(self.width) if self.svm else part[0]


def iter_predict_blocks(path: str, config: Config, block_rows: int = 65536):
    """Bounded-memory feature blocks for streamed file scoring
    (``infer/stream.predict_stream``): float64 ``[<= block_rows, F]`` in
    file order, with the column handling of :func:`_parse_text_file`
    (label stripped, weight / group / ignored columns dropped, LibSVM width
    fixed by a whole-file pass), so a path scored block-wise sees the
    matrix ``Booster.predict(path)`` parses."""
    yield from PredictFile(path, config).blocks(block_rows)


def _load_two_round(path: str, config: Config,
                    reference: Optional[BinnedDataset]) -> BinnedDataset:
    """``two_round=true`` out-of-core text ingestion (reference:
    DatasetLoader::LoadFromFile with use_two_round_loading): pass 1
    indexes the data lines, the quantile sketches see every row in chunks
    of ``CHUNK_ROWS`` rows, then each chunk is parsed again and binned on
    the config's device by B straight into the u8 / u16 matrix. The dense
    float matrix never exists whole: peak memory is the binned matrix and
    the chunks the parse threads hold (``_WORKERS`` + 1)."""
    tf = _TextFile(path, config)
    n = tf.n
    if n == 0:
        log.fatal("Data file %s holds no rows", path)
    svm = tf.fmt == "libsvm"
    ds = BinnedDataset()
    ds.num_data = n
    ds.max_bin = config.max_bin
    if reference is not None:
        ds._adopt_reference(reference)
        width = reference.num_total_features
        if svm:
            width = max(width, tf.libsvm_width())
    else:
        # the sketches of the JAX package's pass, over every row; a LibSVM
        # column first seen in a later chunk takes the earlier rows as
        # zeros, which a sketch only counts
        sketches: List[QuantileSketch] = []
        for lo, part in zip(range(0, n, CHUNK_ROWS), tf.chunks()):
            if svm:
                for _ in range(len(sketches), part.max_col + 1):
                    sk = QuantileSketch(budget=config.stream_sketch_budget)
                    sk.push(np.zeros(lo))
                    sketches.append(sk)
                X = part.dense(len(sketches))
            else:
                X = part[0]
                if not sketches:
                    sketches = [QuantileSketch(
                        budget=config.stream_sketch_budget)
                        for _ in range(X.shape[1])]
            for j, sk in enumerate(sketches):
                sk.push(X[:, j])
        width = len(sketches) if svm else len(tf.keep)
        if svm and width == 0:
            sketches = [QuantileSketch(budget=config.stream_sketch_budget)]
            sketches[0].push(np.zeros(n))
            width = 1
        fnames = _kept_names(tf.header_names, tf.keep)
        ds.feature_names = fnames or [f"Column_{i}" for i in range(width)]
        _mappers_from_sketches(ds, sketches, config,
                               set(resolve_categorical(config, fnames)))
    ds.num_total_features = width
    if config.linear_tree:
        log.warning("two_round=true does not retain the raw matrix; "
                    "linear_tree needs in-memory loading")

    # ---- pass 2: chunked parse + bin on the device --------------------------
    device = resolve_device(config.device_type)
    binned = np.empty((n, len(ds.used_features)),
                      bin_dtype(ds.feature_num_bins))
    y_all = np.empty(n, np.float32)
    w_all = (np.empty(n, np.float32)
             if not svm and tf.weight_col is not None else None)
    q_all = np.empty(n, np.int64) if svm or tf.group_col is not None \
        else None
    for lo, part in zip(range(0, n, CHUNK_ROWS), tf.chunks()):
        hi = min(lo + CHUNK_ROWS, n)
        if svm:
            X, y, w, q = part.dense(width), part.label, None, part.qid
        else:
            X, y, w, q = part
        binned[lo:hi] = ds._bin_block(X, device)
        y_all[lo:hi] = y
        if w_all is not None:
            w_all[lo:hi] = w
        if q_all is not None:
            q_all[lo:hi] = q
    ds.binned = binned

    md = ds.metadata
    md.label = y_all
    if w_all is not None:
        md.weight = w_all
    group = None
    if q_all is not None and (q_all >= 0).any():
        if (q_all < 0).any():
            log.fatal("LibSVM file %s mixes rows with and without "
                      "'qid:' tokens; every row needs one", path)
        group = _rows_to_sizes(q_all)
    if w_all is None:
        w = _load_sidecar(path, ".weight", np.float64)
        if w is not None:
            md.weight = w.astype(np.float32)
    for suffix in (".query", ".group"):
        q = _load_sidecar(path, suffix, np.int64)
        if q is not None:
            group = q
            break
    md.init_score = _load_sidecar(path, ".init", np.float64)
    md.position = _load_sidecar(path, ".position", np.int64)
    md.set_group(group)
    md.check(ds.num_data)
    return ds


def resolve_categorical(config: Config,
                        feature_names: Optional[List[str]]) -> List[int]:
    """``categorical_feature`` -> feature indices; ``name:<col>`` tokens
    resolve against the loaded feature names."""
    categorical: List[int] = []
    if config.categorical_feature:
        for tok in str(config.categorical_feature).split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("name:"):
                name = tok[5:]
                if feature_names and name in feature_names:
                    categorical.append(feature_names.index(name))
                else:
                    log.fatal("categorical_feature name %r not found in "
                              "header", name)
            else:
                categorical.append(int(tok))
    return categorical


def load_data_file(path: str, config: Config,
                   reference: Optional[BinnedDataset] = None
                   ) -> BinnedDataset:
    """Load a text data file (or a binary cache) into a BinnedDataset
    (reference: DatasetLoader::LoadFromFile). Files past
    ``stream_ingest_threshold_mb`` and ``two_round=true`` load block-wise
    (:func:`_load_two_round`)."""
    if path.endswith(".bin") and os.path.exists(path):
        return load_binary(path)
    if config.two_round:
        return _load_two_round(path, config, reference)
    thr = config.stream_ingest_threshold_mb
    try:
        fsize = os.path.getsize(path)
    except OSError:
        fsize = 0
    if thr > 0 and fsize > thr << 20:
        log.info("data file %s is %.0f MB (> stream_ingest_threshold_mb="
                 "%d); ingesting in bounded row blocks", path,
                 fsize / 2**20, thr)
        return _load_two_round(path, config, reference)
    X, y, weight, qgroups, fnames = _parse_text_file(path, config)
    return BinnedDataset.from_matrix(
        X, config, label=y, weight=weight, group=qgroups,
        init_score=_load_sidecar(path, ".init", np.float64),
        position=_load_sidecar(path, ".position", np.int64),
        categorical_features=resolve_categorical(config, fnames),
        feature_names=fnames, reference=reference)


def raw_matrix_of(path: str, config: Config):
    """The raw (unbinned) matrix of a text data file with the column
    handling and sidecars of :func:`load_data_file`: (X, label, weight or
    None, group sizes or None, feature names or None)."""
    return _parse_text_file(path, config)


# ---------------------------------------------------------------------------
# the binary dataset cache (reference: save_binary task + LoadFromBinFile)
# ---------------------------------------------------------------------------
def save_binary(ds: BinnedDataset, path: str) -> None:
    """The JAX package's npz layout and magic (numpy appends ``.npz`` to a
    path without it, as there)."""
    md = ds.metadata
    np.savez_compressed(
        path,
        __magic__=BINARY_MAGIC,
        binned=ds.binned,
        used_features=np.asarray(ds.used_features, np.int64),
        feature_num_bins=np.asarray(ds.feature_num_bins, np.int64),
        num_total_features=ds.num_total_features,
        feature_names=np.asarray(ds.feature_names),
        mappers=np.frombuffer(pickle.dumps(ds.mappers), dtype=np.uint8),
        label=md.label if md.label is not None else np.empty(0),
        weight=md.weight if md.weight is not None else np.empty(0),
        query_boundaries=(md.query_boundaries
                          if md.query_boundaries is not None
                          else np.empty(0)),
        init_score=(md.init_score if md.init_score is not None
                    else np.empty(0)),
        position=(md.position if md.position is not None else np.empty(0)),
    )
    log.info("Saved binary dataset to %s", path)


class _MapperUnpickler(pickle.Unpickler):
    """Reads the pickled mapper list of either package's cache as this
    package's ``BinMapper``; every other global is refused."""

    _MODULES = ("lambdagap_tpu.data.binning",
                "lambdagap_tpu_torch.data.binning")

    def find_class(self, module: str, name: str):
        if module in self._MODULES and name == "BinMapper":
            return BinMapper
        raise pickle.UnpicklingError(
            f"binary dataset cache: refusing global {module}.{name}")


def load_binary(path: str) -> BinnedDataset:
    z = np.load(path, allow_pickle=False)
    if str(z["__magic__"]) != BINARY_MAGIC:
        log.fatal("%s is not a lambdagap_tpu binary dataset", path)
    ds = BinnedDataset()
    ds.binned = z["binned"]
    ds.num_data = ds.binned.shape[0]
    ds.used_features = [int(x) for x in z["used_features"]]
    ds.feature_num_bins = [int(x) for x in z["feature_num_bins"]]
    ds.num_total_features = int(z["num_total_features"])
    ds.feature_names = [str(x) for x in z["feature_names"]]
    ds.mappers = _MapperUnpickler(io.BytesIO(z["mappers"].tobytes())).load()
    ds.bin_offsets = [int(v) for v in np.concatenate(
        [[0], np.cumsum(ds.feature_num_bins)[:-1]])]
    md = ds.metadata
    md.label = z["label"] if z["label"].size else None
    md.weight = z["weight"] if z["weight"].size else None
    md.query_boundaries = (z["query_boundaries"]
                           if z["query_boundaries"].size else None)
    md.init_score = z["init_score"] if z["init_score"].size else None
    md.position = z["position"] if z["position"].size else None
    return ds
