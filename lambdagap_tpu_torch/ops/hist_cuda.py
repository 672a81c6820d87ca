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
adds nothing to any channel. On a CUDA tensor each launches its kernel
(``csrc/hist.cu``, ``csrc/hist_q.cu``; the designs and bounds are described
there) or raises; only a CPU tensor takes the plain version
(:func:`_hist_reference`, :func:`_hist_q_reference`). The Pallas kernels'
channel packings (``pack_gh8``'s bf16 hi/lo split, ``pack_ghq8``) existed to
feed the TPU's matrix unit and are not carried over: K1 takes f32 grad and
hess as they are, K2 the int8 levels and the mask as they are.

Both kernels are deterministic: K1 has no float atomics and a fixed
summation order, K2 sums integers, so two launches on the same inputs are
``torch.equal``. K1 also sums in float64 and rounds once, as its plain
version does, so the card's histograms are the CPU's to the bit but for a
float64 sum that lands within its own rounding error of a float32 rounding
boundary: the same training on the card and on the CPU then samples the
same rows under GOSS and bagging, which turn a 1-ulp difference in a
histogram into another sample.
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

# row blocks: at most two per SM of an H100 (132 SMs), at least ~2K rows
# each, so a leaf's partials stay a small fraction of its row bytes
_MAX_ROW_BLOCKS = 264
_MIN_BLOCK_ROWS = 2048
# shared memory budget of one block, so two blocks fit one SM (227 KB)
_SMEM_BUDGET = 100 * 1024

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()

Count = Union[int, torch.Tensor]


def exact_accum_limit(hist_impl: str) -> int:
    """Largest integer the quantized-histogram level accumulator holds
    exactly (``hist_pallas.py:58-70``): int32 max for ``pallas``, whose
    counterpart K2 accumulates int32; 2**24 (integer-valued float32) for
    the JAX package's one-hot contraction."""
    return 2**31 - 1 if hist_impl == "pallas" else 2**24


def _declare(lib: ctypes.CDLL, source: str) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if source == HIST_SOURCE:
        lib.lg_hist_rows.argtypes = [
            p, i32, i64,            # bins, bin_bytes, F
            p, p, p,                # grad, hess, mask (or null)
            p, i64,                 # rows (or null), P
            p, i64,                 # count_ptr (or null), count_const
            i32, i32, i32,          # num_bins, row blocks, feature tile
            p, p, p]                # partial, out, stream
        lib.lg_hist_rows.restype = ctypes.c_int
        lib.lg_hist_smem_bytes.argtypes = [i32, i32, i32]
        lib.lg_hist_smem_bytes.restype = ctypes.c_int
    else:
        lib.lg_hist_rows_q.argtypes = [
            p, i32, i64,            # bins, bin_bytes, F
            p, p, p,                # gq, hq, mask (or null)
            p, i64,                 # rows (or null), P
            p, i64,                 # count_ptr (or null), count_const
            i32, i32, i32,          # num_bins, row blocks, feature tile
            p, p]                   # out, stream
        lib.lg_hist_rows_q.restype = ctypes.c_int
        lib.lg_hist_q_smem_bytes.argtypes = [i32, i32, i32]
        lib.lg_hist_q_smem_bytes.restype = ctypes.c_int


def _kernel_lib(source: str) -> ctypes.CDLL:
    """The built library of ``csrc/<source>`` with every argtype
    declared."""
    with _lib_lock:
        if source not in _libs:
            from ..utils import cuda_build
            lib = cuda_build.load(source)
            _declare(lib, source)
            _libs[source] = lib
        return _libs[source]


def _positions(bins: torch.Tensor, rows: Optional[torch.Tensor]) -> int:
    return bins.shape[0] if rows is None else rows.shape[0]


def _check(name, bins, chans, rows, count, num_bins, mask) -> None:
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
    if isinstance(count, torch.Tensor):
        if count.dtype != torch.int32 or count.numel() != 1:
            raise TypeError(f"{name}: a tensor count must be one int32")
        tensors.append(("count", count))
    for label, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, bins on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not 1 <= num_bins <= (256 if bins.dtype == torch.uint8 else 65536):
        raise ValueError(f"{name}: num_bins={num_bins} out of range for "
                         f"{bins.dtype}")


def _live(bins, rows, count, mask):
    """(row id [P] with dead positions replaced by row 0, live [P]) for the
    plain versions: positions past ``count`` are never read through, and
    out-of-bag rows are not live."""
    P = _positions(bins, rows)
    pos = torch.arange(P, device=bins.device)
    valid = pos < count
    r = pos if rows is None else rows.long()
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


def _hist_reference(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, rows: Optional[torch.Tensor],
                    count: Count, num_bins: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`hist_rows` in torch ops: the sums are
    taken in float64 and returned as float32. Positions past ``count`` are
    replaced by row 0 before anything is read through them; their channels,
    and those of out-of-bag rows, are zeroed."""
    r, valid = _live(bins, rows, count, mask)
    ch = torch.stack([torch.where(valid, grad[r].double(), 0.0),
                      torch.where(valid, hess[r].double(), 0.0),
                      valid.double()], dim=1)                 # [P, 3]
    return _scatter(bins, r, ch, num_bins, torch.float64).float()


def _hist_q_reference(bins: torch.Tensor, gq: torch.Tensor,
                      hq: torch.Tensor, rows: Optional[torch.Tensor],
                      count: Count, num_bins: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`hist_rows_q`: integer sums in int64,
    returned as int32."""
    r, valid = _live(bins, rows, count, mask)
    zero = torch.zeros((), dtype=torch.int64, device=bins.device)
    ch = torch.stack([torch.where(valid, gq[r].long(), zero),
                      torch.where(valid, hq[r].long(), zero),
                      valid.long()], dim=1)                   # [P, 3]
    return _scatter(bins, r, ch, num_bins, torch.int64).int()


def _grid(lib_smem, bins: torch.Tensor, P: int,
          num_bins: int) -> Tuple[int, int]:
    """(row blocks, feature tile): the widest feature tile whose shared
    histogram fits the budget, and enough row blocks to fill the card."""
    F = bins.shape[1]
    esize = bins.element_size()
    f_tile = F
    while f_tile > 1 and lib_smem(esize, f_tile, num_bins) > _SMEM_BUDGET:
        f_tile = (f_tile + 1) // 2
    nblk = max(1, min(_MAX_ROW_BLOCKS, -(-P // _MIN_BLOCK_ROWS)))
    return nblk, f_tile


def _count_args(count: Count):
    if isinstance(count, torch.Tensor):
        return count.data_ptr(), 0
    return None, int(count)


def hist_rows(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              rows: Optional[torch.Tensor], count: Count, num_bins: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram of a leaf -> f32 ``[F, num_bins, 3]`` (sum of grad, sum of
    hess, row count per feature and bin).

    bins: u8/u16 ``[N, F]`` C-contiguous; grad, hess: f32 ``[N]``; rows:
    int32 positions ``[P]`` (the leaf's slice of the permutation) or None
    for rows ``0..N-1``; count: the number of live positions, a Python int
    or a one-element int32 tensor on the device (so a launch needs no host
    read); mask: bool ``[N]`` in-bag rows, or None for all. Entries of
    ``rows`` past ``count`` are never dereferenced.

    On a CUDA tensor this launches the kernel on the current stream (one
    launch counted) and raises if the launch fails; on a CPU tensor it runs
    the plain version."""
    _check("hist_rows", bins, (("grad", grad, torch.float32),
                               ("hess", hess, torch.float32)),
           rows, count, num_bins, mask)
    if bins.device.type == "cpu":
        return _hist_reference(bins, grad, hess, rows, count, num_bins, mask)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows runs on cuda or cpu, not {bins.device}")
    dev = bins.device
    F = bins.shape[1]
    lib = _kernel_lib(HIST_SOURCE)
    nblk, f_tile = _grid(lib.lg_hist_smem_bytes, bins,
                         _positions(bins, rows), num_bins)
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((nblk, F, num_bins, 3), dtype=torch.float64,
                          device=dev)
    cptr, cconst = _count_args(count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_rows(
            bins.data_ptr(), bins.element_size(), F, grad.data_ptr(),
            hess.data_ptr(), None if mask is None else mask.data_ptr(),
            None if rows is None else rows.data_ptr(),
            _positions(bins, rows), cptr, cconst, num_bins, nblk, f_tile,
            partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed (code {rc})")
    HIST_LAUNCHES.add()
    return out


def hist_rows_q(bins: torch.Tensor, gq: torch.Tensor, hq: torch.Tensor,
                rows: Optional[torch.Tensor], count: Count, num_bins: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized histogram of a leaf -> int32 ``[F, num_bins, 3]`` (sum of
    g_q, sum of h_q, in-bag row count per feature and bin), exact.

    gq, hq: int8 ``[N]`` gradient levels (:func:`quantize_gradients`);
    bins, rows, count and mask as for :func:`hist_rows`. The caller keeps
    ``rows x num_grad_quant_bins`` below ``exact_accum_limit("pallas")``.
    On a CUDA tensor this launches K2 (one launch counted) or raises; on a
    CPU tensor it runs the plain version."""
    _check("hist_rows_q", bins, (("gq", gq, torch.int8),
                                 ("hq", hq, torch.int8)),
           rows, count, num_bins, mask)
    if bins.device.type == "cpu":
        return _hist_q_reference(bins, gq, hq, rows, count, num_bins, mask)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows_q runs on cuda or cpu, not "
                         f"{bins.device}")
    dev = bins.device
    F = bins.shape[1]
    lib = _kernel_lib(HIST_Q_SOURCE)
    nblk, f_tile = _grid(lib.lg_hist_q_smem_bytes, bins,
                         _positions(bins, rows), num_bins)
    out = torch.zeros((F, num_bins, 3), dtype=torch.int32, device=dev)
    cptr, cconst = _count_args(count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_rows_q(
            bins.data_ptr(), bins.element_size(), F, gq.data_ptr(),
            hq.data_ptr(), None if mask is None else mask.data_ptr(),
            None if rows is None else rows.data_ptr(),
            _positions(bins, rows), cptr, cconst, num_bins, nblk, f_tile,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"quantized histogram kernel launch failed "
                           f"(code {rc})")
    HIST_Q_LAUNCHES.add()
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
