"""Leaf histograms: the hand-written CUDA kernels that replace the JAX
package's Pallas histogram kernels (K1, K2).

The counterpart of ``lambdagap_tpu/ops/hist_pallas.py``:

* :func:`hist_rows` (``hist_pallas`` and its ``_hist_kernel``, K1) sums
  ``(grad, hess, 1)`` of the first ``count`` positions of a leaf's row
  list into the bin of every feature -> f32 ``[F, B, 3]``;
* :func:`hist_rows_q` (``hist_pallas_q`` and its ``_hist_kernel_q``, K2)
  sums the int8 gradient levels ``(g_q, h_q, 1)`` -> int32 ``[F, B, 3]``;
* :func:`quantize_gradients` is the JAX package's discretization of
  grad/hess to those levels, with its ``jax.random`` stochastic rounding.

Both take an optional in-bag mask ``[N]`` (bagging/GOSS): a masked-out row
adds nothing to any channel; and an optional device ``offset``. A leaf is
passed either as a row list — a view of its parent's slice of the
permutation, position p reads ``rows[offset + p]`` (``tree_layout=gather``)
— or, with no row list, as a window of leaf-ordered copies of the bins and
channels: position p reads row ``offset + p`` of ``bins``, the channels and
the mask alike (``tree_layout=sorted``; the JAX package's
``leaf_histogram_sorted``, ``lambdagap_tpu/ops/histogram.py:170-195``).
Rows at or past ``offset + count`` are never read: in a window they are the
next leaf's. On a CUDA tensor each launches
its kernel (``csrc/hist.cu``, ``csrc/hist_q.cu``; the designs and bounds
are described there) or raises; only a CPU tensor takes the plain version
(:func:`_hist_reference`, :func:`_hist_q_reference`). The Pallas kernels'
channel packings (``pack_gh8``'s bf16 hi/lo split, ``pack_ghq8``) existed
to feed the TPU's matrix unit and are not carried over.

Both kernels sum exact integers, so two launches on the same inputs are
``torch.equal``, and each equals its plain version bit for bit. K2 sums the
int8 levels. K1 sums grad and hess in 64-bit fixed point at a
power-of-two scale 2^k per channel (:func:`hist_scale`, chosen from the
largest magnitude and the row count so that no sum can overflow) and
rounds each sum to f32 once: the card's histograms are the CPU's, so the
same training on both samples the same rows under GOSS and bagging, which
turn a 1-ulp difference in a histogram into another sample. A fixed-point
sum of m values is within m * 2^-(k+1) of the exact sum (``csrc/hist.cu``
states the bound).

K1's accumulate mode serves ``data_residency=stream``, where a histogram
spans many uploaded windows of rows: :func:`hist_acc` makes an int64
accumulator the caller holds, :func:`hist_rows_add` adds a window's
fixed-point sums into it (one launch, no rounding) and :func:`hist_finish`
rounds the total to f32 once. With the tree's own scale the result is
bit-equal to one :func:`hist_rows` over the same rows; the plain versions
(:func:`_hist_add_reference`, :func:`_hist_finish_reference`) make the same
split.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from ..config import MAX_QUANT_BINS
from ..infer.engine import LaunchCounter
from ..utils import prng

HIST_SOURCE = "hist.cu"
HIST_Q_SOURCE = "hist_q.cu"
HIST_LAUNCHES = LaunchCounter()
HIST_Q_LAUNCHES = LaunchCounter()
# the launches of each kernel with no row list (a window of the rows
# themselves: a root, or a leaf of tree_layout=sorted), also counted above
HIST_WINDOW_LAUNCHES = LaunchCounter()
HIST_Q_WINDOW_LAUNCHES = LaunchCounter()
# K1's accumulate mode: the launches of hist_rows_add (one a streamed
# window) and of hist_finish (one a streamed histogram), not counted above
HIST_STREAM_LAUNCHES = LaunchCounter()
HIST_FINISH_LAUNCHES = LaunchCounter()

# each block takes at least this many live rows, so its fixed cost (zeroing
# and flushing its shared histogram) is spread over enough adds; a small
# leaf's few row blocks are then split by feature (_grid). With that split,
# 2048 was the best of 512 / 1024 / 2048 at a 41,176-row leaf for both
# kernels on the H100, the root unchanged (PERF.md section 6, PR 4)
_MIN_BLOCK_ROWS = 2048
# the fixed-point scale never assumes fewer than 2^24 rows: a value then
# has at most 38 magnitude bits, which K1 splits into two 32-bit words
# whose sums over a 4,096-row window stay exact (csrc/hist.cu)
_SCALE_MIN_ROW_BITS = 24

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
# per (source, device index): the device's shared-memory limit, its SMs
_devices: Dict[Tuple[str, int], Tuple[int, int]] = {}
_occupancy: Dict[Tuple, int] = {}
# K1's int64 accumulator per (device index, stream): zero between launches.
# K1 is two launches (the sums into it, then the f32 pass that zeroes it);
# _ws_lock is held while both are enqueued, so two host threads on one
# stream cannot queue one's sums between the other's two launches
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}
_ws_lock = threading.Lock()

Count = Union[int, torch.Tensor]


# the largest level sum K2's int32 accumulator holds exactly; a learner
# whose rows x num_grad_quant_bins reaches it builds each quantized
# histogram from windows of at most K2_ACCUM_LIMIT // num_grad_quant_bins
# positions summed in int64 (ops/histogram.leaf_histogram). A module
# constant, so a run can lower it in-process to exercise the windows
K2_ACCUM_LIMIT = 2**31 - 1


def exact_accum_limit(hist_impl: str) -> int:
    """Largest integer the quantized-histogram level accumulator holds
    exactly (``hist_pallas.py:58-70``): int32 max (``K2_ACCUM_LIMIT``) for
    ``pallas``, whose counterpart K2 accumulates int32; 2**24
    (integer-valued float32) for the JAX package's one-hot contraction."""
    return K2_ACCUM_LIMIT if hist_impl == "pallas" else 2**24


def hist_scale(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """K1's fixed-point exponents ``(k_g, k_h)``, int32 ``[2]`` on the
    gradients' device (no host read).

    For each channel, e is the exponent of the largest magnitude over all
    N rows (a max, so it does not depend on the order of the rows), read
    from its float32 bits so that max < 2^e; n is the bit length of N, so
    N < 2^n; and k = 62 - max(n, _SCALE_MIN_ROW_BITS) - e. A value v
    becomes ``round_half_even(v * 2^k)``, at most 2^(62 - max(n, 24)) <=
    2^38 in magnitude — small enough for K1's two 32-bit words — so a sum
    over at most N rows stays below 2^62."""
    n = max(int(grad.shape[0]).bit_length(), _SCALE_MIN_ROW_BITS)
    m = torch.stack([grad.abs().amax(), hess.abs().amax()])
    biased = (m.view(torch.int32) >> 23) & 0xFF
    e = torch.clamp(biased, min=1) - 126
    return (62 - n - e).to(torch.int32)


def _exp2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float64, built from its bits (exact on every device)."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def _declare(lib: ctypes.CDLL, source: str) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    pre = "lg_hist" if source == HIST_SOURCE else "lg_hist_q"
    for name in (f"{pre}_smem_bytes", f"{pre}_occupancy"):
        getattr(lib, name).argtypes = [i32, i32, i32]
        getattr(lib, name).restype = ctypes.c_int
    getattr(lib, f"{pre}_setup").argtypes = []
    getattr(lib, f"{pre}_setup").restype = ctypes.c_int
    if source == HIST_SOURCE:
        head = [p, i32, i64,        # bins, bin_bytes, F
                p, p, p,            # grad, hess, mask (or null)
                p, p, i64,          # rows (or null), offset (or null), P
                p, i64,             # count_ptr (or null), count_const
                p,                  # scale (k_g, k_h)
                i32, i32, i32,      # num_bins, row blocks, feature tile
                i32]                # min rows per block
        lib.lg_hist_rows.argtypes = head + [p, p, p]  # workspace, out, stream
        lib.lg_hist_rows_add.argtypes = head + [p, p]  # acc, stream
        lib.lg_hist_finish.argtypes = [p, i64, p, p, p]
        for name in ("lg_hist_rows", "lg_hist_rows_add", "lg_hist_finish"):
            getattr(lib, name).restype = ctypes.c_int
    else:
        lib.lg_hist_rows_q.argtypes = [
            p, i32, i64,            # bins, bin_bytes, F
            p, p, p,                # gq, hq, mask (or null)
            p, p, i64,              # rows (or null), offset (or null), P
            p, i64,                 # count_ptr (or null), count_const
            i32, i32, i32,          # num_bins, row blocks, feature tile
            i32,                    # min rows per block
            p, p]                   # out, stream
        lib.lg_hist_rows_q.restype = ctypes.c_int


def _kernel_lib(source: str, dev: torch.device) -> ctypes.CDLL:
    """The built library of ``csrc/<source>`` with every argtype declared
    and its shared-memory limit raised on ``dev`` (once per device)."""
    with _lib_lock:
        if source not in _libs:
            from ..utils import cuda_build
            lib = cuda_build.load(source)
            _declare(lib, source)
            _libs[source] = lib
        lib = _libs[source]
        key = (source, dev.index)
        if key not in _devices:
            setup = lib.lg_hist_setup if source == HIST_SOURCE \
                else lib.lg_hist_q_setup
            with torch.cuda.device(dev):
                max_smem = setup()
            if max_smem <= 0:
                raise RuntimeError(f"{source}: shared-memory setup failed "
                                   f"(code {-max_smem})")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _devices[key] = (max_smem, sms)
        return lib


def _positions(bins: torch.Tensor, rows: Optional[torch.Tensor]) -> int:
    return bins.shape[0] if rows is None else rows.shape[0]


def _check(name, bins, chans, rows, count, num_bins, mask, offset,
           scale=None) -> None:
    """Device, type, shape and contiguity of a histogram call's inputs;
    ``chans`` is ((label, tensor, dtype), ...) of the per-row channels."""
    dev = bins.device
    if bins.dtype not in (torch.uint8, torch.uint16) or bins.dim() != 2:
        raise TypeError(f"{name}: bins must be u8/u16 [N, F], got "
                        f"{bins.dtype} {tuple(bins.shape)}")
    tensors = [("bins", bins)]
    n = bins.shape[0]
    for label, t, dtype in chans:
        if t.dtype != dtype or t.shape != (n,):
            short = {torch.float32: "f32", torch.int8: "int8"}[dtype]
            raise TypeError(f"{name}: {label} must be {short} [{n}], got "
                            f"{t.dtype} {tuple(t.shape)}")
        tensors.append((label, t))
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (n,):
            raise TypeError(f"{name}: mask must be bool [{n}], got "
                            f"{mask.dtype} {tuple(mask.shape)}")
        tensors.append(("mask", mask))
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 1:
            raise TypeError(f"{name}: rows must be int32 [P], got "
                            f"{rows.dtype} {tuple(rows.shape)}")
        tensors.append(("rows", rows))
    for label, t, size in (("count", count, 1), ("offset", offset, 1),
                           ("scale", scale, 2)):
        if isinstance(t, torch.Tensor):
            if t.dtype != torch.int32 or t.numel() != size:
                raise TypeError(f"{name}: a tensor {label} must be "
                                f"{size} int32")
            tensors.append((label, t))
    if offset is not None and not isinstance(offset, torch.Tensor):
        raise TypeError(f"{name}: offset is a one-element int32 tensor on "
                        "the device, not a host number")
    for label, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, bins on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not 1 <= num_bins <= (256 if bins.dtype == torch.uint8 else 65536):
        raise ValueError(f"{name}: num_bins={num_bins} out of range for "
                         f"{bins.dtype}")


def _live(bins, rows, count, mask, offset):
    """(row id [P] with dead positions replaced by row 0, live [P]) for the
    plain versions: position p reads ``rows[offset + p]``, or row ``offset
    + p`` with no row list (a window); positions at or past ``count`` (or
    past the list or the rows) are never read through, and out-of-bag rows
    are not live."""
    P = _positions(bins, rows)
    pos = torch.arange(P, device=bins.device)
    at = pos if offset is None else pos + offset.long()
    valid = (pos < count) & (at < P)
    if rows is None:
        r = at
    else:
        r = rows.long()[torch.where(valid, at, 0)]
    r = torch.where(valid, r, 0)
    if mask is not None:
        valid = valid & mask[r]
    return r, valid


def _scatter(bins, r, vals, num_bins, dtype) -> torch.Tensor:
    """Sum ``vals`` [P, 3] of each position into its bin of every feature
    with ``index_add_`` in ``dtype``."""
    dev = bins.device
    P, F = r.shape[0], bins.shape[1]
    if bins.dtype == torch.uint16:      # torch's CUDA indexing has no u16
        bins = bins.int()
    b = bins[r].long()                                        # [P, F]
    flat = (b + torch.arange(F, device=dev) * num_bins).reshape(-1)
    v = vals[:, None, :].expand(P, F, 3).reshape(-1, 3)
    keep = (b < num_bins).reshape(-1)
    out = torch.zeros((F * num_bins, 3), dtype=dtype, device=dev)
    out.index_add_(0, flat[keep], v[keep])
    return out.reshape(F, num_bins, 3)


def _hist_sums(bins, grad, hess, rows, count, num_bins, mask, offset,
               scale) -> torch.Tensor:
    """The fixed-point sums of the plain versions, int64 ``[F, B, 3]``:
    ``round_half_even(v * 2^k)`` summed exactly with ``index_add_``.
    Positions past ``count`` are replaced by row 0 before anything is read
    through them; their channels, and those of out-of-bag rows, are
    zeroed."""
    r, valid = _live(bins, rows, count, mask, offset)
    sc = _exp2(scale)
    zero = torch.zeros((), dtype=torch.int64, device=bins.device)
    ch = torch.stack([
        torch.where(valid, torch.round(grad[r].double() * sc[0]).long(), zero),
        torch.where(valid, torch.round(hess[r].double() * sc[1]).long(), zero),
        valid.long()], dim=1)                                 # [P, 3]
    return _scatter(bins, r, ch, num_bins, torch.int64)


def _hist_finish_reference(acc: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`hist_finish`: each int64 sum rounded to
    f32 once as ``float(double(S) * 2^-k)``; ``acc`` is left all zero."""
    inv = torch.cat([_exp2(-scale), torch.ones(1, dtype=torch.float64,
                                               device=acc.device)])
    out = (acc.double() * inv).float()
    acc.zero_()
    return out


def _hist_reference(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, rows: Optional[torch.Tensor],
                    count: Count, num_bins: int,
                    mask: Optional[torch.Tensor] = None,
                    offset: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`hist_rows` in torch ops: the fixed-point
    sums (:func:`_hist_sums`) rounded once (:func:`_hist_finish_reference`)."""
    if scale is None:
        scale = hist_scale(grad, hess)
    return _hist_finish_reference(_hist_sums(
        bins, grad, hess, rows, count, num_bins, mask, offset, scale), scale)


def _hist_add_reference(acc: torch.Tensor, bins: torch.Tensor,
                        grad: torch.Tensor, hess: torch.Tensor,
                        rows: Optional[torch.Tensor], count: Count,
                        num_bins: int, mask: Optional[torch.Tensor],
                        offset: Optional[torch.Tensor],
                        scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`hist_rows_add`: ``acc`` += the
    positions' fixed-point sums."""
    acc += _hist_sums(bins, grad, hess, rows, count, num_bins, mask, offset,
                      scale)
    return acc


def _hist_q_reference(bins: torch.Tensor, gq: torch.Tensor,
                      hq: torch.Tensor, rows: Optional[torch.Tensor],
                      count: Count, num_bins: int,
                      mask: Optional[torch.Tensor] = None,
                      offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`hist_rows_q`: integer sums in int64,
    returned as int32."""
    r, valid = _live(bins, rows, count, mask, offset)
    zero = torch.zeros((), dtype=torch.int64, device=bins.device)
    ch = torch.stack([torch.where(valid, gq[r].long(), zero),
                      torch.where(valid, hq[r].long(), zero),
                      valid.long()], dim=1)                   # [P, 3]
    return _scatter(bins, r, ch, num_bins, torch.int64).int()


def _grid(source: str, lib, dev: torch.device, bins: torch.Tensor, P: int,
          num_bins: int) -> Tuple[int, int]:
    """(row blocks, feature tile): the widest feature tile whose block
    fits the card's shared memory, halved while the positions fill too few
    row blocks (``_MIN_BLOCK_ROWS`` each) to cover the card's SMs twice — a
    small leaf then spreads over more, lighter blocks; and as many row
    blocks as the card holds at once or the positions fill, whichever is
    fewer."""
    pre = "lg_hist" if source == HIST_SOURCE else "lg_hist_q"
    smem = getattr(lib, f"{pre}_smem_bytes")
    max_smem, sms = _devices[(source, dev.index)]
    F, es = bins.shape[1], bins.element_size()

    def need(t: int) -> int:
        return smem(es, t, num_bins)

    row_blocks = -(-P // _MIN_BLOCK_ROWS)
    f_tile = F
    while f_tile > 1 and (need(f_tile) > max_smem or
                          row_blocks * -(-F // f_tile) < 2 * sms):
        f_tile = (f_tile + 1) // 2
    key = (source, dev.index, es, f_tile, num_bins)
    if key not in _occupancy:
        _occupancy[key] = getattr(lib, f"{pre}_occupancy")(es, f_tile,
                                                           num_bins)
    occ = _occupancy[key]
    if occ <= 0:
        raise ValueError(f"{source}: {num_bins} bins need {need(f_tile)} B "
                         f"of shared memory for one feature, more than the "
                         f"card's {max_smem}")
    tiles = -(-F // f_tile)
    nblk = max(1, min(-(-sms * occ // tiles), row_blocks))
    return nblk, f_tile


def _workspace(dev: torch.device, stream: int, numel: int) -> torch.Tensor:
    """K1's int64 accumulator for this device and stream: all zero between
    launches (the kernel's second pass zeroes what it reads). The caller
    holds ``_ws_lock`` until both launches are enqueued."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < numel:
        ws = torch.zeros(numel, dtype=torch.int64, device=dev)
        _workspaces[key] = ws
    return ws


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count_args(count: Count):
    if isinstance(count, torch.Tensor):
        return count.data_ptr(), 0
    return None, int(count)


def hist_rows(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              rows: Optional[torch.Tensor], count: Count, num_bins: int,
              mask: Optional[torch.Tensor] = None,
              offset: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram of a leaf -> f32 ``[F, num_bins, 3]`` (sum of grad, sum of
    hess, row count per feature and bin).

    bins: u8/u16 ``[N, F]`` C-contiguous; grad, hess: f32 ``[N]``; rows:
    int32 ``[P]`` (a slice of the permutation holding the leaf's rows) or
    None for a window of the rows themselves; count: the number of live
    positions, a Python int or a one-element int32 tensor on the device
    (so a launch needs no host read); mask: bool ``[N]`` in-bag rows, or
    None for all; offset: a one-element int32 tensor on the device, or None
    for 0 — position p reads ``rows[offset + p]``, or with no row list row
    ``offset + p`` of bins, grad, hess and mask; scale: the fixed-point
    exponents from :func:`hist_scale`, computed here from grad and hess
    when None (the learner computes them once per tree, over the whole
    dataset). Entries of ``rows``, and rows of a window, at or past
    ``offset + count`` are never read. The grid is sized by the positions
    P (the parent's slice or window) and the live count on the device.

    On a CUDA tensor this launches the kernel on the current stream (one
    launch counted, and one window launch when there is no row list) and
    raises if the launch fails; on a CPU tensor it runs the plain
    version."""
    _check("hist_rows", bins, (("grad", grad, torch.float32),
                               ("hess", hess, torch.float32)),
           rows, count, num_bins, mask, offset, scale)
    if bins.device.type == "cpu":
        return _hist_reference(bins, grad, hess, rows, count, num_bins, mask,
                               offset, scale)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows runs on cuda or cpu, not {bins.device}")
    dev = bins.device
    F = bins.shape[1]
    if scale is None:
        scale = hist_scale(grad, hess)
    lib = _kernel_lib(HIST_SOURCE, dev)
    P = _positions(bins, rows)
    nblk, f_tile = _grid(HIST_SOURCE, lib, dev, bins, P, num_bins)
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    cptr, cconst = _count_args(count)
    with torch.cuda.device(dev), _ws_lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        acc = _workspace(dev, stream, F * num_bins * 3)
        rc = lib.lg_hist_rows(
            bins.data_ptr(), bins.element_size(), F, grad.data_ptr(),
            hess.data_ptr(), _ptr(mask), _ptr(rows), _ptr(offset), P, cptr,
            cconst, scale.data_ptr(), num_bins, nblk, f_tile,
            _MIN_BLOCK_ROWS, acc.data_ptr(), out.data_ptr(), stream)
        if rc != 0:                     # it may hold a partial sum now
            _workspaces.pop((dev.index, stream), None)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed (code {rc})")
    HIST_LAUNCHES.add()
    if rows is None:
        HIST_WINDOW_LAUNCHES.add()
    return out


def hist_acc(num_features: int, num_bins: int,
             device: torch.device) -> torch.Tensor:
    """A zeroed int64 ``[F, num_bins, 3]`` accumulator for
    :func:`hist_rows_add` (the caller holds it across windows)."""
    return torch.zeros((num_features, num_bins, 3), dtype=torch.int64,
                       device=device)


def _check_acc(name: str, acc: torch.Tensor, dev: torch.device, F: int,
               num_bins: int) -> None:
    if acc.dtype != torch.int64 or acc.shape != (F, num_bins, 3) \
            or acc.device != dev or not acc.is_contiguous():
        raise TypeError(f"{name}: acc must be a contiguous int64 [{F}, "
                        f"{num_bins}, 3] on {dev}, got {acc.dtype} "
                        f"{tuple(acc.shape)} on {acc.device}")


def hist_rows_add(acc: torch.Tensor, bins: torch.Tensor, grad: torch.Tensor,
                  hess: torch.Tensor, rows: Optional[torch.Tensor],
                  count: Count, num_bins: int, scale: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's accumulate mode: add the fixed-point sums of a window of rows
    into ``acc`` (:func:`hist_acc`), with no rounding; returns ``acc``.

    bins, grad, hess, rows, count, mask and offset as for
    :func:`hist_rows`; ``scale`` is required: the tree's exponents from
    :func:`hist_scale` over the whole dataset's gradients, so that the
    sums over every window stay exact. On a CUDA tensor this launches K1
    once on the current stream (one launch counted in
    ``HIST_STREAM_LAUNCHES``) or raises; on a CPU tensor it runs the plain
    version."""
    _check("hist_rows_add", bins, (("grad", grad, torch.float32),
                                   ("hess", hess, torch.float32)),
           rows, count, num_bins, mask, offset, scale)
    if not isinstance(scale, torch.Tensor):
        raise TypeError("hist_rows_add: scale is the tree's hist_scale "
                        "tensor")
    _check_acc("hist_rows_add", acc, bins.device, bins.shape[1], num_bins)
    if bins.device.type == "cpu":
        return _hist_add_reference(acc, bins, grad, hess, rows, count,
                                   num_bins, mask, offset, scale)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows_add runs on cuda or cpu, not "
                         f"{bins.device}")
    dev = bins.device
    lib = _kernel_lib(HIST_SOURCE, dev)
    P = _positions(bins, rows)
    nblk, f_tile = _grid(HIST_SOURCE, lib, dev, bins, P, num_bins)
    cptr, cconst = _count_args(count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_rows_add(
            bins.data_ptr(), bins.element_size(), bins.shape[1],
            grad.data_ptr(), hess.data_ptr(), _ptr(mask), _ptr(rows),
            _ptr(offset), P, cptr, cconst, scale.data_ptr(), num_bins, nblk,
            f_tile, _MIN_BLOCK_ROWS, acc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed (code {rc})")
    HIST_STREAM_LAUNCHES.add()
    return acc


def hist_finish(acc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The f32 ``[F, B, 3]`` histogram of an accumulator: each int64 sum
    rounded once as ``float(double(S) * 2^-k)``; ``acc`` is left all zero.
    On a CUDA tensor one launch of K1's finishing kernel (counted in
    ``HIST_FINISH_LAUNCHES``) or a raise; on a CPU tensor the plain
    version."""
    if not isinstance(scale, torch.Tensor) or scale.dtype != torch.int32 \
            or scale.numel() != 2 or scale.device != acc.device:
        raise TypeError("hist_finish: scale must be the int32 [2] "
                        "hist_scale tensor on the accumulator's device")
    _check_acc("hist_finish", acc, acc.device, acc.shape[0], acc.shape[1])
    if acc.device.type == "cpu":
        return _hist_finish_reference(acc, scale)
    if acc.device.type != "cuda":
        raise ValueError(f"hist_finish runs on cuda or cpu, not "
                         f"{acc.device}")
    dev = acc.device
    lib = _kernel_lib(HIST_SOURCE, dev)
    out = torch.empty(acc.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_finish(acc.data_ptr(), acc.numel(),
                                scale.contiguous().data_ptr(),
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"histogram finish launch failed (code {rc})")
    HIST_FINISH_LAUNCHES.add()
    return out


def hist_rows_q(bins: torch.Tensor, gq: torch.Tensor, hq: torch.Tensor,
                rows: Optional[torch.Tensor], count: Count, num_bins: int,
                mask: Optional[torch.Tensor] = None,
                offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized histogram of a leaf -> int32 ``[F, num_bins, 3]`` (sum of
    g_q, sum of h_q, in-bag row count per feature and bin), exact.

    gq, hq: int8 ``[N]`` gradient levels (:func:`quantize_gradients`: g_q
    in [-128, 127], h_q in [0, 127], the range K2's packed words take);
    bins, rows, count, mask and offset as for :func:`hist_rows`. The
    caller keeps ``rows x num_grad_quant_bins`` below
    ``exact_accum_limit("pallas")``. On a CUDA tensor this launches K2 (one
    launch counted) or raises; a negative h_q there gives undefined sums,
    since checking it would cost a host read per launch. On a CPU tensor it
    refuses a negative h_q and runs the plain version."""
    _check("hist_rows_q", bins, (("gq", gq, torch.int8),
                                 ("hq", hq, torch.int8)),
           rows, count, num_bins, mask, offset)
    if bins.device.type == "cpu":
        if hq.numel() and int(hq.min()) < 0:
            raise ValueError("hist_rows_q: h_q must lie in [0, 127]")
        return _hist_q_reference(bins, gq, hq, rows, count, num_bins, mask,
                                 offset)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows_q runs on cuda or cpu, not "
                         f"{bins.device}")
    dev = bins.device
    F = bins.shape[1]
    lib = _kernel_lib(HIST_Q_SOURCE, dev)
    P = _positions(bins, rows)
    nblk, f_tile = _grid(HIST_Q_SOURCE, lib, dev, bins, P, num_bins)
    out = torch.zeros((F, num_bins, 3), dtype=torch.int32, device=dev)
    cptr, cconst = _count_args(count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_rows_q(
            bins.data_ptr(), bins.element_size(), F, gq.data_ptr(),
            hq.data_ptr(), _ptr(mask), _ptr(rows), _ptr(offset), P, cptr,
            cconst, num_bins, nblk, f_tile, _MIN_BLOCK_ROWS,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"quantized histogram kernel launch failed "
                           f"(code {rc})")
    HIST_Q_LAUNCHES.add()
    if rows is None:
        HIST_Q_WINDOW_LAUNCHES.add()
    return out


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       key: torch.Tensor, num_bins: int,
                       stochastic: bool = True):
    """Discretize grad/hess to signed int8 levels (``hist_pallas.py:278``;
    reference: GradientDiscretizer::DiscretizeGradients). Returns
    ``(g_q int8, h_q int8, g_scale, h_scale)``, the scales as float32 0-d
    tensors on the gradients' device.

    Stochastic rounding adds ``jax.random.uniform`` noise drawn from the
    two halves of ``split(key)`` (``utils/prng``), so the levels equal the
    JAX package's bit for bit on the same gradients and key. Every step is
    float32; the scale divisions take tensor divisors, so CUDA's
    reciprocal-multiply shortcut for a host scalar divisor never applies."""
    dev = grad.device
    qb = max(2, min(num_bins, MAX_QUANT_BINS))
    half = max(qb // 2, 1)

    def f32(v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=dev)

    gmax = torch.maximum(torch.max(torch.abs(grad)), f32(1e-12))
    hmax = torch.maximum(torch.max(hess), f32(1e-12))
    gs = gmax / f32(half)
    hs = hmax / f32(qb)
    g = grad / gs
    h = hess / hs
    if stochastic:
        k = prng.split(key)
        g = torch.floor(g + prng.uniform(k[0], g.shape, dev))
        h = torch.floor(h + prng.uniform(k[1], h.shape, dev))
    else:
        g = torch.round(g)
        h = torch.round(h)
    gq = torch.clamp(g, -MAX_QUANT_BINS, MAX_QUANT_BINS).to(torch.int8)
    hq = torch.clamp(h, 0, MAX_QUANT_BINS).to(torch.int8)
    return gq, hq, gs, hs
