"""Leaf histograms: the hand-written CUDA kernel that replaces the JAX
package's Pallas histogram kernel (K1).

The counterpart of ``lambdagap_tpu/ops/hist_pallas.py`` (``hist_pallas``
and its ``_hist_kernel``): :func:`hist_rows` sums ``(grad, hess, 1)`` of
the first ``count`` positions of a leaf's row list into the bin of every
feature -> f32 ``[F, B, 3]``. On a CUDA tensor it launches
``csrc/hist.cu`` (the design and its bound are described there) or
raises; only a CPU tensor takes the plain version,
:func:`_hist_reference`. The Pallas kernel's bf16 hi/lo split of grad and
hess (``pack_gh8``) existed to feed the TPU's bf16 matrix unit and is not
carried over: the kernel takes f32 grad and hess as they are.

The kernel is deterministic (no f32 atomics; fixed summation order), so two
launches on the same inputs are ``torch.equal``. The quantized-gradient
kernel (``hist_pallas_q``, K2) waits for the next slice.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Union

import torch

from ..infer.engine import LaunchCounter

HIST_SOURCE = "hist.cu"
HIST_LAUNCHES = LaunchCounter()

# row blocks: at most two per SM of an H100 (132 SMs), at least ~2K rows
# each, so a leaf's partials stay a small fraction of its row bytes
_MAX_ROW_BLOCKS = 264
_MIN_BLOCK_ROWS = 2048
# shared memory budget of one block, so two blocks fit one SM (227 KB)
_SMEM_BUDGET = 100 * 1024

_lib = None
_lib_lock = threading.Lock()

Count = Union[int, torch.Tensor]


def _kernel_lib() -> ctypes.CDLL:
    """The built ``hist.cu`` library with every argtype declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load(HIST_SOURCE)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.lg_hist_rows.argtypes = [
                p, i32, i64,            # bins, bin_bytes, F
                p, p,                   # grad, hess
                p, i64,                 # rows (or null), P
                p, i64,                 # count_ptr (or null), count_const
                i32, i32, i32,          # num_bins, row blocks, feature tile
                p, p, p]                # partial, out, stream
            lib.lg_hist_rows.restype = ctypes.c_int
            lib.lg_hist_smem_bytes.argtypes = [i32, i32, i32]
            lib.lg_hist_smem_bytes.restype = ctypes.c_int
            _lib = lib
        return _lib


def _positions(bins: torch.Tensor, rows: Optional[torch.Tensor]) -> int:
    return bins.shape[0] if rows is None else rows.shape[0]


def _check(bins, grad, hess, rows, count, num_bins) -> None:
    dev = bins.device
    if bins.dtype not in (torch.uint8, torch.uint16) or bins.dim() != 2:
        raise TypeError(f"hist_rows: bins must be u8/u16 [N, F], got "
                        f"{bins.dtype} {tuple(bins.shape)}")
    for name, t in (("grad", grad), ("hess", hess)):
        if t.dtype != torch.float32 or t.shape != (bins.shape[0],):
            raise TypeError(f"hist_rows: {name} must be f32 [{bins.shape[0]}],"
                            f" got {t.dtype} {tuple(t.shape)}")
    tensors = [("bins", bins), ("grad", grad), ("hess", hess)]
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 1:
            raise TypeError(f"hist_rows: rows must be int32 [P], got "
                            f"{rows.dtype} {tuple(rows.shape)}")
        tensors.append(("rows", rows))
    if isinstance(count, torch.Tensor):
        if count.dtype != torch.int32 or count.numel() != 1:
            raise TypeError("hist_rows: a tensor count must be one int32")
        tensors.append(("count", count))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"hist_rows: {name} is on {t.device}, bins on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"hist_rows: {name} must be contiguous")
    if not 1 <= num_bins <= (256 if bins.dtype == torch.uint8 else 65536):
        raise ValueError(f"hist_rows: num_bins={num_bins} out of range for "
                         f"{bins.dtype}")


def _hist_reference(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, rows: Optional[torch.Tensor],
                    count: Count, num_bins: int) -> torch.Tensor:
    """The plain version of :func:`hist_rows` in torch ops: the sums are
    taken in float64 and returned as float32. Positions past ``count`` are
    replaced by row 0 before anything is read through them, and their
    channels are zeroed."""
    dev = bins.device
    P = _positions(bins, rows)
    F = bins.shape[1]
    pos = torch.arange(P, device=dev)
    valid = pos < count
    r = pos if rows is None else rows.long()
    r = torch.where(valid, r, 0)
    if bins.dtype == torch.uint16:      # torch's CUDA indexing has no u16
        bins = bins.int()
    b = bins[r].long()                                        # [P, F]
    ch = torch.stack([torch.where(valid, grad[r].double(), 0.0),
                      torch.where(valid, hess[r].double(), 0.0),
                      valid.double()], dim=1)                 # [P, 3]
    flat = (b + torch.arange(F, device=dev) * num_bins).reshape(-1)
    vals = ch[:, None, :].expand(P, F, 3).reshape(-1, 3)
    keep = (b < num_bins).reshape(-1)
    out = torch.zeros((F * num_bins, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, flat[keep], vals[keep])
    return out.reshape(F, num_bins, 3).float()


def hist_rows(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              rows: Optional[torch.Tensor], count: Count,
              num_bins: int) -> torch.Tensor:
    """Histogram of a leaf -> f32 ``[F, num_bins, 3]`` (sum of grad, sum of
    hess, row count per feature and bin).

    bins: u8/u16 ``[N, F]`` C-contiguous; grad, hess: f32 ``[N]``; rows:
    int32 positions ``[P]`` (the leaf's slice of the permutation) or None
    for rows ``0..N-1``; count: the number of live positions, a Python int
    or a one-element int32 tensor on the device (so a launch needs no host
    read). Entries of ``rows`` past ``count`` are never dereferenced.

    On a CUDA tensor this launches the kernel on the current stream (one
    launch counted) and raises if the launch fails; on a CPU tensor it runs
    the plain version."""
    _check(bins, grad, hess, rows, count, num_bins)
    if bins.device.type == "cpu":
        return _hist_reference(bins, grad, hess, rows, count, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_rows runs on cuda or cpu, not {bins.device}")
    dev = bins.device
    P = _positions(bins, rows)
    F = bins.shape[1]
    lib = _kernel_lib()
    esize = bins.element_size()
    f_tile = F
    while f_tile > 1 and lib.lg_hist_smem_bytes(esize, f_tile,
                                                num_bins) > _SMEM_BUDGET:
        f_tile = (f_tile + 1) // 2
    nblk = max(1, min(_MAX_ROW_BLOCKS, -(-P // _MIN_BLOCK_ROWS)))
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    partial = (out if nblk == 1 else
               torch.empty((nblk, F, num_bins, 3), dtype=torch.float32,
                           device=dev))
    tensor_count = isinstance(count, torch.Tensor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lg_hist_rows(
            bins.data_ptr(), esize, F, grad.data_ptr(), hess.data_ptr(),
            None if rows is None else rows.data_ptr(), P,
            count.data_ptr() if tensor_count else None,
            0 if tensor_count else int(count),
            num_bins, nblk, f_tile, partial.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed (code {rc})")
    HIST_LAUNCHES.add()
    return out
