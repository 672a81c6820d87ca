#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed N] [--rows N] [--only kernels]

Run from the root of a checkout. Phases, each fatal on failure:

1. the card (name and power limit, as nvidia-smi reports them) and the
   torch / CUDA / nvcc versions;
2. build every kernel of every path from ``lambdagap_tpu_torch/csrc/``
   (traverse.cu, hist.cu, hist_q.cu: one nvcc per source, all started
   together) into the git-ignored build dir, printing each kernel's
   registers, shared memory and spills; then the histogram kernels'
   atomics in SASS (``cuobjdump -sass``): every shared-memory add must be
   native, none a compare-and-swap loop;
3. build a HIGGS-width forest from ``--seed`` (binary, 28 features, 500
   trees of 255 leaves, thresholds on a 254-boundary grid per feature,
   NaN- and zero-missing nodes) and round-trip it through the port's text
   writer and parser;
4. the traversal kernel against its plain PyTorch version on the card,
   on every node block of that forest's artifact at 1, 8, 601 and 4096
   rows (NaN and zero rows mixed in) and on a 70-category forest with
   hostile values: the node carries must be ``torch.equal``; then the
   kernel's and the plain version's times (CUDA events, median of 30) and
   the kernel's bound;
5. the serving path: ``Booster(model_str=...).as_server(raw_score=True)``
   on the card answers requests of 1..4096 rows from 4 threads, each
   answer ``array_equal`` to the port's scan oracle on the card; the launch
   counts are zeroed just before and read just after;
T2. the f32 histogram kernel (K1) against its plain version on the card at
   seven shapes (the HIGGS root, a leaf read at an offset inside its
   parent's slice with junk around it, u16 bins with a ragged count, count
   0, the root with a bagging mask, a skewed root with 90% of the rows in
   one bin, extreme gradients from 1e-30 to 1e3 at a leaf one row past
   three blocks' row budget): every channel ``torch.equal`` (both sum the
   same fixed-point integers), a rerun ``torch.equal``; then the kernel's,
   the plain version's and ``index_add_``'s times and the bound at the
   root, the leaf, the skewed and the masked root;
T2q. the int8 histogram kernel (K2) against its plain version at six
   shapes (the masked HIGGS root, the leaf at an offset, u16 bins with a
   ragged count, count 0, a saturated root with every row in bin 0 at
   g_q = -127 and h_q = 127, the skewed root): ``torch.equal``, reruns
   ``torch.equal``; the same times at the root, the leaf and the skewed
   root;
T3. the training path: ``lgt.train`` on the card, binary, HIGGS width (28
   features, ``num_leaves=255``, ``max_bin=255``), ``--rows`` seeded
   synthetic rows (10,500,000, HIGGS's count, by default) plus a 500,000-row
   validation set, 10 rounds with ``early_stopping(5)``; the launch counts
   are zeroed just before and read just after, and the K1 launches must
   equal the leaf histograms the learner built; one more tree with CUDA
   events around its phases, and one under ``torch.profiler`` for K1's
   kernel-only device time summed over its launches;
T6. T3's configuration and Datasets with ``use_quantized_grad`` (4
   levels, stochastic rounding, ``quant_train_renew_leaf``) and bagging
   0.8/1: the K2 launches equal the leaf histograms built, no K1 launch,
   the validation logloss falls; one tree's phases and K2's kernel-only
   time, the threefry draw's time, peak memory; the model served back
   against the scan oracle;
T4. the example shape (16,000 x 20, 63 leaves, 30 rounds, validation set,
   early stopping) trained on the card and on the CPU, f32, quantized (16
   levels, renew), GOSS and bagging 0.7/1: predictions on the training
   rows within rtol 1e-4 / atol 1e-5, ``best_iteration`` equal; the
   quantized validation AUC within 0.02 of the f32 one;
T5. the T3 model through ``model_to_string`` -> ``Booster(model_str=)`` ->
   ``as_server(raw_score=True)``: a burst, each answer ``array_equal`` to
   the scan oracle on the card;
T7. EFB: 200,000 rows of 8 dense features and 4 groups of 6 mutually
   exclusive sparse columns (bundles form, fewer columns than features),
   f32 and quantized, on the card and on the CPU at T4's bar, K1 and K2
   launched;
6. the kernels line (one JSON object) and, last, the device line.

Needs one card; exits non-zero, printing no result, when there is none.
Imports nothing of JAX nor of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

F = 28              # HIGGS features
T = 500             # boosting rounds (binary: one tree each)
LEAVES = 255        # num_leaves
GRID = 254          # thresholds per feature: max_bin=255 binning
SIZES = (1, 7, 64, 512, 601, 4096)   # request rows, cycled
REQUESTS = 240
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
# 32-bit integer adds outside the tensor cores: 64 INT32 lanes per SM, half
# the f32 lanes, and no fused multiply-add to count twice — a quarter of
# the f32 rate
H100_INT32_OPS_PER_S = H100_F32_OPS_PER_S / 4
HIGGS_ROWS = 10_500_000         # HIGGS's training rows (bench.py)
VALID_ROWS = 500_000
MAX_BIN = 255
ROUNDS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs: CUDA events around
    each run, all enqueued behind a device-side sleep long enough to cover
    the host's enqueueing, so the host's launch overhead never shows as
    device time (a run that synchronizes inside waits the sleep out and
    then counts its own host gaps)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # ~2 GHz SM clock: sleep for twice the enqueue time, at most 1 s
    torch.cuda._sleep(int(min(1.0, 2 * host_s * reps + 1e-3) * 2e9))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def wall_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median host wall of ``fn`` ended by a device synchronize."""
    import torch
    for _ in range(warm):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled_kernel_ms(run, names) -> tuple:
    """(device ms, launches) of the kernels whose names contain one of
    ``names``, summed over one call of ``run``, from torch.profiler's CUDA
    activity (CUPTI): the kernels' own time, no launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us, calls = 0.0, 0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            us += getattr(e, "device_time_total", 0.0)
            calls += e.count
    return us / 1e3, calls


def steps_taken(artifact, carry: np.ndarray) -> int:
    """Decision steps this carry needed: for each (row, group) the depth
    of the leaf it reached in the group's pruned structure."""
    b = artifact.buffers
    lo = np.asarray(b["block_node_lo"])
    glo = np.asarray(b["block_group_lo"])
    left, right = np.asarray(b["node_left"]), np.asarray(b["node_right"])
    root = np.asarray(b["root"])
    G = root.shape[0]
    L = int(np.asarray(b["leaf_value"]).shape[1])
    depth_of = np.zeros((G, L), np.int64)
    for blk in range(len(lo) - 1):
        for g in range(int(glo[blk]), int(glo[blk + 1])):
            stack = [(int(root[g]), 0)]
            while stack:
                n, d = stack.pop()
                if n < 0:
                    depth_of[g, ~n] = d
                    continue
                k = int(lo[blk]) + n
                stack.append((int(left[k]), d + 1))
                stack.append((int(right[k]), d + 1))
    leaf = ~carry.astype(np.int64)
    return int(depth_of[np.arange(G)[None, :], leaf].sum())


def kernel_bound(x, tables, out_shape, steps: int):
    import torch
    nbytes = x.numel() * 4 + out_shape[0] * out_shape[1] * 4
    nbytes += sum(int(a.nbytes) for a in tables
                  if isinstance(a, torch.Tensor))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = steps / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def burst(server, data: np.ndarray, plan, clients: int = 4):
    """Submit every (offset, rows) request of ``plan`` from ``clients``
    threads at once; returns (answers in plan order, seconds)."""
    answers = [None] * len(plan)
    errors = []

    def client(tid: int) -> None:
        futs = [(i, server.submit(data[plan[i][0]:plan[i][0] + plan[i][1]]))
                for i in range(tid, len(plan), clients)]
        for i, f in futs:
            try:
                answers[i] = f.result(timeout=300).values
            except Exception as e:  # noqa: BLE001 — reported, fails below
                errors.append(f"request {i}: {e!r}")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    seconds = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "serve clients hung")
    check(not errors, "; ".join(errors[:3]))
    return answers, seconds


def check_answers(answers, plan, oracle) -> None:
    for i, (lo, n) in enumerate(plan):
        check(answers[i].shape == (n,) and
              np.array_equal(answers[i], oracle[lo:lo + n]),
              f"request {i} ({n} rows) != scan oracle")


def higgs_like(seed: int, n: int, f: int = F):
    """Seeded synthetic rows of HIGGS's shape: ``f`` f32 features (some
    heavy-tailed and non-negative, like its momenta) and a binary label
    from a nonlinear score plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[:, 5::4] = np.abs(X[:, 5::4]) ** 1.5
    z = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3] ** 2
         + 0.4 * np.sin(2.0 * X[:, 4]) + 0.2 * X[:, 5] - 0.2 * X[:, 9]
         + 0.7 * rng.standard_normal(n, dtype=np.float32))
    return X, (z > 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# T2: the histogram kernels against their plain versions
# ---------------------------------------------------------------------------
def hist_bound(bins, rows, count: int, num_bins: int, mask=None,
               chan_bytes: int = 8, int_ops: int = 5):
    """Least time for hist_rows (chan_bytes 8: f32 grad and hess; int_ops
    5: four 32-bit integer adds of the split fixed-point words and one
    count increment per (row, feature)) or hist_rows_q (2: int8 levels;
    2: two 32-bit adds of the packed words): each live row's bins and
    channels (and its row id when
    there is a row list, its mask byte when there is a mask) read once,
    the [F, B, 3] result written once; the integer adds at the card's
    32-bit integer rate outside the tensor cores. Bound by bytes at every
    shape here."""
    F_ = bins.shape[1]
    nbytes = (count * (F_ * bins.element_size() + chan_bytes
                       + (4 if rows is not None else 0)
                       + (1 if mask is not None else 0))
              + F_ * num_bins * 3 * 4)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = count * F_ * int_ops / H100_INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def index_add_call(bins, grad, hess, rows, count: int, num_bins: int,
                   mask=None, offset: int = 0):
    """One ``index_add_`` that computes the same histogram from the
    gathered [count * F, 3] channels — f32 for K1, int64 for K2's int8
    levels; a masked-out row's channels are zero (timed only; the port
    never calls it)."""
    import torch
    dev = bins.device
    r = (torch.arange(count, device=dev) if rows is None
         else rows[offset:offset + count].long())
    b = (bins.int() if bins.dtype == torch.uint16 else bins)[r].long()
    F_ = bins.shape[1]
    idx = (b + torch.arange(F_, device=dev) * num_bins).reshape(-1)
    dtype = torch.float32 if grad.dtype == torch.float32 else torch.int64
    live = (torch.ones(count, dtype=dtype, device=dev) if mask is None
            else mask[r].to(dtype))
    ch = torch.stack([grad[r].to(dtype) * live, hess[r].to(dtype) * live,
                      live], 1)
    vals = ch[:, None, :].expand(count, F_, 3).reshape(-1, 3).contiguous()
    out = torch.zeros((F_ * num_bins, 3), dtype=dtype, device=dev)
    return lambda: out.zero_().index_add_(0, idx, vals)


def hist_inputs(dev, gen):
    """The HIGGS-width bins and the shapes both histogram phases share:
    the root's bins, a skewed copy (90% of the rows in bin 0 of every
    feature), a leaf of N/255 rows at an offset inside its parent's slice
    with junk everywhere else in the slice (the kernel must never read
    through a position outside [offset, offset + count)), and u16 bins."""
    import torch
    N = HIGGS_ROWS
    bins = torch.randint(0, MAX_BIN, (N, F), generator=gen, device=dev,
                         dtype=torch.uint8)
    skewed = bins.clone()
    skewed[torch.rand(N, generator=gen, device=dev) < 0.9] = 0
    leaf = N // 255
    off = leaf + 3                      # the right child of a split
    parent = torch.randperm(N, generator=gen, device=dev)[:off + leaf].int()
    parent[:off] = 2 ** 31 - 1
    n16 = 100_003
    bins16 = torch.randint(0, 1024, (n16, 8), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint16)
    rows16 = torch.randperm(n16, generator=gen, device=dev)[:90_000].int()
    return bins, skewed, leaf, off, parent, bins16, rows16


def one(dev, v: int):
    """A one-element int32 on the device: the launch reads it there."""
    import torch
    return torch.tensor([v], dtype=torch.int32, device=dev)


def time_hist(tag: str, name: str, kernel, plain, args, count: int,
              offset: int, smi: str, chan_bytes: int, int_ops: int):
    """The kernel's, the plain version's and index_add_'s times at one
    shape, and the bound; printed, returned as a dict."""
    import torch
    k_ms = cuda_ms(lambda: kernel(*args))
    p_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
    bins, a1, a2, rows, _, nb, mask = args[:7]
    lib = index_add_call(bins, a1, a2, rows, count, nb, mask, offset)
    l_ms = cuda_ms(lib, reps=5, warm=1)
    del lib
    torch.cuda.empty_cache()
    bound, by, nbytes = hist_bound(bins, rows, count, nb, mask, chan_bytes,
                                   int_ops)
    print(f"{tag} [{name}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"index_add_ {l_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB); kernel {'beats' if k_ms < l_ms else
          'loses to'} index_add_ ({l_ms / k_ms:.2f}x) [{smi}]")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound, "bound_by": by}


def hist_phase(dev, seed: int, smi: str) -> dict:
    """T2: K1 against its plain version at seven shapes, every channel
    ``torch.equal`` (the same fixed-point integers), reruns ``torch.equal``;
    times at the root, the leaf, the skewed root and the masked root."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = HIGGS_ROWS
    bins, skewed, leaf, off, parent, bins16, rows16 = hist_inputs(dev, gen)
    grad = torch.randn(N, generator=gen, device=dev)
    hess = torch.rand(N, generator=gen, device=dev) * 0.25
    bag = torch.rand(N, generator=gen, device=dev) < 0.8
    g16 = torch.randn(bins16.shape[0], generator=gen, device=dev)
    h16 = torch.rand(bins16.shape[0], generator=gen, device=dev)
    # extreme gradients: magnitudes 1e-30 to 1e3, both signs
    sign = torch.randint(0, 2, (N,), generator=gen, device=dev) * 2 - 1
    gx = 10.0 ** (torch.rand(N, generator=gen, device=dev) * 33 - 30) * sign
    hx = 10.0 ** (torch.rand(N, generator=gen, device=dev) * 33 - 30)
    budget = 3 * hc._MIN_BLOCK_ROWS + 1
    # the fixed-point exponents, once per gradient set (the learner: once
    # per tree), so a timed launch is the launch alone
    k, k16, kx = (hc.hist_scale(grad, hess), hc.hist_scale(g16, h16),
                  hc.hist_scale(gx, hx))

    cases = [
        ("a: HIGGS root, 28 u8 features, all rows",
         (bins, grad, hess, None, N, 256, None, None, k), N, 0),
        ("b: a leaf, N/255 rows at an offset in its parent's slice, junk "
         "around it", (bins, grad, hess, parent, one(dev, leaf), 256, None,
                       one(dev, off), k), leaf, off),
        ("c: u16 bins, 1024 bins x 8 features, ragged count",
         (bins16, g16, h16, rows16, 77_777, 1024, None, None, k16), 77_777,
         0),
        ("d: count = 0", (bins, grad, hess, parent, one(dev, 0), 256, None,
                          one(dev, off), k), 0, off),
        ("e: HIGGS root with a bagging mask (fraction 0.8)",
         (bins, grad, hess, None, N, 256, bag, None, k), int(bag.sum()), 0),
        ("f: skewed root, 90% of the rows in bin 0 of every feature",
         (skewed, grad, hess, None, N, 256, None, None, k), N, 0),
        (f"g: extreme gradients (1e-30 to 1e3), a leaf of {budget} rows "
         "(one past three blocks' row budget)",
         (bins, gx, hx, parent, one(dev, budget), 256, bag, one(dev, off),
          kx), budget, off),
    ]
    max_err = 0.0
    timed = {}
    for name, args, live, offset in cases:
        got = hc.hist_rows(*args)
        again = hc.hist_rows(*args)
        ref = hc._hist_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K1 rerun not bit-identical ({name})")
        check(torch.equal(got, ref),
              f"K1 != plain ({name}): {int((got != ref).sum())} entries "
              "differ")
        counted = int(got[..., 2].double().sum())
        check(name[0] == "g" or counted == live * args[0].shape[1],
              f"K1 counted rows wrongly ({name})")
        max_err = max(max_err, float((got - ref).abs().max()))
        print(f"K1 == plain [{name}]: torch.equal on every channel, rerun "
              "bit-identical")
        if name[0] in "abef":
            rows, mask = args[3], args[6]
            count = live if name[0] != "e" else N
            timed[name[0]] = time_hist("K1", name, hc.hist_rows,
                                       hc._hist_reference, args, count,
                                       offset, smi, 8, 5)
    print(f"K1 launches in the comparisons: {hc.HIST_LAUNCHES.launches} "
          "(not counted below)")
    del bins, skewed, grad, hess, parent, bag, gx, hx
    torch.cuda.empty_cache()
    return {**timed["a"], "max_abs_err": max_err, "leaf": timed["b"],
            "skewed": timed["f"], "masked": timed["e"]}


def hist_q_phase(dev, seed: int, smi: str) -> dict:
    """T2q: K2 against its plain version at six shapes, all torch.equal
    (integer sums), reruns torch.equal; times at the root, the leaf and the
    skewed root."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = HIGGS_ROWS
    bins, skewed, leaf, off, parent, bins16, rows16 = hist_inputs(dev, gen)
    # num_grad_quant_bins=4 levels: g in [-2, 2], h in [0, 4]
    gq = torch.randint(-2, 3, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    hq = torch.randint(0, 5, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    bag = torch.rand(N, generator=gen, device=dev) < 0.8
    n16 = bins16.shape[0]
    gq16 = torch.randint(-63, 64, (n16,), generator=gen, device=dev,
                         dtype=torch.int8)
    hq16 = torch.randint(0, 127, (n16,), generator=gen, device=dev,
                         dtype=torch.int8)
    bag16 = torch.rand(n16, generator=gen, device=dev) < 0.7
    # saturated: every row in bin 0 at the extreme levels, no mask, so each
    # block's packed fields reach their flush budget
    zeros = torch.zeros_like(bins)
    g_sat = torch.full((N,), -127, dtype=torch.int8, device=dev)
    h_sat = torch.full((N,), 127, dtype=torch.int8, device=dev)

    cases = [
        ("a: HIGGS root, 28 u8 features, bagging mask 0.8",
         (bins, gq, hq, None, N, 256, bag), None, N, 0),
        ("b: a leaf, N/255 rows at an offset in its parent's slice, junk "
         "around it", (bins, gq, hq, parent, one(dev, leaf), 256, bag,
                       one(dev, off)), None, leaf, off),
        ("c: u16 bins, 1024 bins x 8 features, ragged count, mask 0.7",
         (bins16, gq16, hq16, rows16, 77_777, 1024, bag16), None, 77_777, 0),
        ("d: count = 0", (bins, gq, hq, parent, one(dev, 0), 256, bag,
                          one(dev, off)), None, 0, off),
        ("e: saturated, every row in bin 0 with g_q = -127, h_q = 127",
         (zeros, g_sat, h_sat, None, N, 256, None), None, N, 0),
        ("f: skewed root, 90% of the rows in bin 0, mask 0.8",
         (skewed, gq, hq, None, N, 256, bag), None, N, 0),
    ]
    for name, args, _, count, offset in cases:
        got = hc.hist_rows_q(*args)
        again = hc.hist_rows_q(*args)
        ref = hc._hist_q_reference(*args)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, ref),
              f"K2 != plain ({name}): "
              f"{int((got != ref).sum())} entries differ")
        check(torch.equal(got, again), f"K2 rerun not bit-identical ({name})")
        rows, mask = args[3], args[6]
        r = (torch.arange(count, device=dev) if rows is None
             else rows[offset:offset + count].long())
        live = count if mask is None else int(mask[r].sum())
        check(int(got[..., 2].long().sum()) == live * args[0].shape[1],
              f"K2 counted rows wrongly ({name})")
        if name[0] == "e":
            check(int(got[0, 0, 0]) == -127 * N and
                  int(got[0, 0, 1]) == 127 * N,
                  f"K2 saturated sums {got[0, 0].tolist()}")
        print(f"K2 == plain [{name}]: torch.equal, rerun bit-identical, "
              f"{live} in-bag rows")
    timed = {}
    for key in "abf":
        name, args, _, count, offset = cases["abcdef".index(key)]
        timed[key] = time_hist("K2", name, hc.hist_rows_q,
                               hc._hist_q_reference, args, count, offset,
                               smi, 2, 2)
    print(f"K2 launches in the comparisons: {hc.HIST_Q_LAUNCHES.launches} "
          "(not counted below)")
    del bins, skewed, gq, hq, parent, bag, zeros, g_sat, h_sat
    torch.cuda.empty_cache()
    return {**timed["a"], "max_abs_err": 0.0, "leaf": timed["b"],
            "skewed": timed["f"]}


def sass_phase() -> None:
    """The histogram kernels' atomics as compiled: every shared-memory add
    native (ATOMS.ADD / ATOMS.POPC.INC), none a compare-and-swap loop; the
    64-bit adds into K1's workspace global reductions (REDG...ADD.64)."""
    from lambdagap_tpu_torch.ops import hist_cuda
    from lambdagap_tpu_torch.utils import cuda_build
    for source in (hist_cuda.HIST_SOURCE, hist_cuda.HIST_Q_SOURCE):
        ops = cuda_build.sass_atomics(source)
        print(f"SASS atomics of {source}: "
              + ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())))
        check(not any("CAS" in k for k in ops),
              f"{source}: an atomic compiled to a compare-and-swap loop")
        check(any(k.startswith("ATOMS.ADD") for k in ops),
              f"{source}: no native shared-memory add")


# ---------------------------------------------------------------------------
# T3-T5: training on the card, card against CPU, serving what was trained
# ---------------------------------------------------------------------------
def train_phase(args, smi: str):
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.infer import TRAVERSE_LAUNCHES
    from lambdagap_tpu_torch.ops.hist_cuda import (HIST_LAUNCHES,
                                                   HIST_Q_LAUNCHES)
    t0 = time.perf_counter()
    Xtr, ytr = higgs_like(args.seed + 100, args.rows)
    Xva, yva = higgs_like(args.seed + 101, VALID_ROWS)
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": LEAVES, "max_bin": MAX_BIN, "learning_rate": 0.1,
              "verbose": -1}
    cfg = lgt.Config.from_params(params)
    t0 = time.perf_counter()
    tr = lgt.Dataset(Xtr, label=ytr)
    va = lgt.Dataset(Xva, label=yva, reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    build_s = time.perf_counter() - t0
    del Xtr
    print(f"T3 data: {args.rows} x {F} train + {VALID_ROWS} valid rows made "
          f"in {gen_s:.1f} s; Dataset construction (binning) {build_s:.1f} s")

    rounds = []

    def per_round(env) -> None:
        lr = env.model._booster.learner
        rounds.append((time.perf_counter(), lr.hist_builds, lr.host_syncs))

    ev = {}
    torch.cuda.reset_peak_memory_stats()
    HIST_LAUNCHES.reset()
    HIST_Q_LAUNCHES.reset()
    TRAVERSE_LAUNCHES.reset()
    t_train = time.perf_counter()
    bst = lgt.train(params, tr, ROUNDS, valid_sets=[va],
                    callbacks=[per_round, lgt.early_stopping(5, verbose=False),
                               lgt.record_evaluation(ev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    launches = HIST_LAUNCHES.launches
    gb = bst._booster
    check(gb.learner.x_rows.device.type == "cuda"
          and gb.scores.device.type == "cuda", "learner tensors not on cuda")
    built = sum(r[1] for r in rounds)
    check(launches > 0, "the training path never launched the K1 kernel")
    check(HIST_Q_LAUNCHES.launches == 0, "the f32 path launched K2")
    check(launches == built, f"K1 launches {launches} != leaf histograms "
          f"built {built}")
    ll = ev["valid_0"]["binary_logloss"]
    auc = ev["valid_0"]["auc"]
    check(ll[-1] < ll[0], f"valid logloss did not fall: {ll[0]} -> {ll[-1]}")
    check(np.isfinite(auc[-1]) and auc[-1] > 0.5, f"valid AUC {auc[-1]}")
    walls = np.diff([t_train] + [r[0] for r in rounds]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    print(f"T3 train: {len(rounds)} rounds in {train_s:.2f} s; wall per "
          f"round (ms, incl. eval) {', '.join(f'{w:.0f}' for w in walls)}; "
          f"median {statistics.median(walls):.1f} ms, median of rounds 2.. "
          f"{statistics.median(walls[1:]):.1f} ms [{smi}]")
    print(f"T3 trees: leaf histograms {[r[1] for r in rounds]}, host syncs "
          f"per tree {[r[2] for r in rounds]}; K1 launches {launches} == "
          f"histograms built; valid logloss {ll[0]:.5f} -> {ll[-1]:.5f}, AUC "
          f"{auc[0]:.5f} -> {auc[-1]:.5f}")
    print(f"T3 device memory: {resident / 1e9:.3f} GB allocated after "
          f"training (binned matrix {gb.learner.resident_bytes() / 1e9:.3f} "
          f"GB of it), peak {peak / 1e9:.3f} GB [{smi}]")
    # one more tree with CUDA events around its phases (after the counts
    # were read; the main path's launches are above)
    lr = gb.learner
    lr.time_phases = True
    grad, hess = gb.boosting()
    t1 = time.perf_counter()
    lr.train_device(grad[0], hess[0])
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    print(f"T3 one tree: {tree_ms:.1f} ms host wall; device-stream time "
          f"between CUDA events: histogram {ph.get('histogram', 0):.1f} ms, "
          f"split scan {ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms; {lr.host_syncs} host syncs "
          f"[{smi}]")
    k_ms, k_calls = profiled_kernel_ms(
        lambda: lr.train_device(grad[0], hess[0]),
        ("hist_kernel", "hist_finish_kernel"))
    print(f"T3 K1 kernel-only device time per tree: {k_ms:.3f} ms over "
          f"{k_calls} kernel launches ({lr.hist_builds} histograms, each the "
          f"main kernel and its f32 pass; torch.profiler), "
          f"{100 * k_ms / tree_ms:.1f}% of the tree's host wall [{smi}]")
    return {"bst": bst, "Xva": Xva, "launches": launches, "train": tr,
            "valid": va, "params": params, "auc": auc[-1]}


def quant_phase(t3: dict, smi: str):
    """T6: T3's configuration with quantized gradients (K2) and bagging, on
    T3's constructed Datasets; the launch counts zeroed just before the
    run and read just after."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    from lambdagap_tpu_torch.utils import prng
    params = {**t3["params"], "use_quantized_grad": True,
              "num_grad_quant_bins": 4, "stochastic_rounding": True,
              "quant_train_renew_leaf": True, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    rounds = []

    def per_round(env) -> None:
        lr = env.model._booster.learner
        rounds.append((time.perf_counter(), lr.hist_builds, lr.host_syncs))

    ev = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hc.HIST_LAUNCHES.reset()
    hc.HIST_Q_LAUNCHES.reset()
    t_train = time.perf_counter()
    bst = lgt.train(params, t3["train"], ROUNDS, valid_sets=[t3["valid"]],
                    callbacks=[per_round, lgt.early_stopping(5, verbose=False),
                               lgt.record_evaluation(ev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    k2, k1 = hc.HIST_Q_LAUNCHES.launches, hc.HIST_LAUNCHES.launches
    gb = bst._booster
    built = sum(r[1] for r in rounds)
    check(gb.learner.quant and gb.scores.device.type == "cuda",
          "T6 did not train quantized on the card")
    check(k2 > 0 and k2 == built, f"K2 launches {k2} != leaf histograms "
          f"built {built}")
    check(k1 == 0, f"the quantized path launched K1 {k1} times")
    ll = ev["valid_0"]["binary_logloss"]
    auc = ev["valid_0"]["auc"]
    check(ll[-1] < ll[0], f"T6 valid logloss did not fall: {ll[0]} -> "
          f"{ll[-1]}")
    check(np.isfinite(auc[-1]) and auc[-1] > 0.5, f"T6 valid AUC {auc[-1]}")
    walls = np.diff([t_train] + [r[0] for r in rounds]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"T6 train (quantized, 4 levels, stochastic rounding, renew, "
          f"bagging 0.8/1): {len(rounds)} rounds in {train_s:.2f} s; wall "
          f"per round (ms, incl. eval) {', '.join(f'{w:.0f}' for w in walls)}"
          f"; median {statistics.median(walls):.1f} ms, median of rounds "
          f"2.. {statistics.median(walls[1:]):.1f} ms [{smi}]")
    print(f"T6 trees: leaf histograms {[r[1] for r in rounds]}, host syncs "
          f"per tree {[r[2] for r in rounds]}; K2 launches {k2} == "
          f"histograms built, K1 launches {k1}; valid logloss {ll[0]:.5f} -> "
          f"{ll[-1]:.5f}, AUC {auc[0]:.5f} -> {auc[-1]:.5f} (T3 f32 "
          f"{t3['auc']:.5f}, gap {auc[-1] - t3['auc']:+.5f}); peak device "
          f"memory {peak / 1e9:.3f} GB [{smi}]")
    # one more tree with CUDA events around its phases (after the counts
    # were read; the main path's launches are above)
    lr = gb.learner
    lr.time_phases = True
    grad, hess = gb.boosting()
    grad, hess, mask = gb.sample_strategy.sample(gb.iter_, grad, hess)
    t1 = time.perf_counter()
    lr.train_device(grad[0], hess[0], mask)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    key = prng.PRNGKey(7)
    draw_ms = cuda_ms(lambda: prng.uniform(key, lr.num_data, grad.device),
                      reps=10, warm=1)
    print(f"T6 one tree: {tree_ms:.1f} ms host wall; device-stream time "
          f"between CUDA events: quantize {ph.get('quantize', 0):.1f} ms, "
          f"histogram {ph.get('histogram', 0):.1f} ms, split scan "
          f"{ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms, renew {ph.get('renew', 0):.1f} "
          f"ms; {lr.host_syncs} host syncs; one threefry draw of "
          f"{lr.num_data} uniforms {draw_ms:.2f} ms, two per tree "
          f"(stochastic rounding) and one per round (bagging) [{smi}]")
    k_ms, k_calls = profiled_kernel_ms(
        lambda: lr.train_device(grad[0], hess[0], mask), ("hist_q_kernel",))
    print(f"T6 K2 kernel-only device time per tree: {k_ms:.3f} ms over "
          f"{k_calls} launches ({lr.hist_builds} histograms; "
          f"torch.profiler), {100 * k_ms / tree_ms:.1f}% of the tree's host "
          f"wall [{smi}]")
    return bst, k2


def card_vs_cpu(params: dict, Xt, yt, Xv, yv, rounds: int):
    """Train the same run on the card and on the CPU. Returns
    {device: (training-row predictions, best_iteration, validation AUC,
    seconds, booster)}."""
    import lambdagap_tpu_torch as lgt
    out = {}
    for device in ("cuda", "cpu"):
        tr = lgt.Dataset(Xt, label=yt)
        va = lgt.Dataset(Xv, label=yv, reference=tr)
        t0 = time.perf_counter()
        bst = lgt.train({**params, "device_type": device}, tr, rounds,
                        valid_sets=[va],
                        callbacks=[lgt.early_stopping(5, verbose=False)])
        out[device] = (bst.predict(Xt), bst.best_iteration,
                       bst.best_score["valid_0"]["auc"],
                       time.perf_counter() - t0, bst)
    (pc, bc, _, _, _), (pp, bp, _, _, _) = out["cuda"], out["cpu"]
    # training rows: the card's histograms equal the CPU's (exact sums),
    # and a tie that one breaks across bins holding no training row routes
    # no training row differently
    check(np.allclose(pc, pp, rtol=1e-4, atol=1e-5),
          f"card != CPU predictions (max |diff| {np.abs(pc - pp).max()}; "
          f"{params})")
    check(bc == bp, f"best_iteration card {bc} != CPU {bp} ({params})")
    return out


def card_vs_cpu_phase() -> None:
    """T4: the example shape, f32 / quantized / GOSS / bagging, each on the
    card and on the CPU."""
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    base = {"objective": "binary", "metric": ["auc", "binary_logloss"],
            "num_leaves": 63, "learning_rate": 0.1, "verbose": -1}
    variants = [
        ("f32", {}),
        ("quantized (16 levels, renew)", {
            "use_quantized_grad": True, "num_grad_quant_bins": 16,
            "quant_train_renew_leaf": True}),
        ("GOSS", {"data_sample_strategy": "goss"}),
        ("bagging 0.7/1", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    ]
    aucs = {}
    for name, extra in variants:
        out = card_vs_cpu({**base, **extra}, X[:16_000], y[:16_000],
                          X[16_000:], y[16_000:], 30)
        (pc, bc, ac, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        aucs[name] = ac
        print(f"T4 card == CPU [{name}]: predictions max |diff| "
              f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}, valid AUC "
              f"{ac:.5f}; train {sc:.1f} s on the card, {sp:.1f} s on the "
              "CPU")
    gap = aucs["quantized (16 levels, renew)"] - aucs["f32"]
    check(abs(gap) <= 0.02, f"quantized AUC {gap:+.4f} from f32's (> 0.02)")
    print(f"T4 quantized valid AUC within 0.02 of f32's ({gap:+.5f})")


def efb_phase(smi: str) -> None:
    """T7: a bundle-forming table (8 dense features + 4 groups of 6
    mutually exclusive sparse columns) trained f32 and quantized, on the
    card and on the CPU."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(3)
    n = 200_000
    dense = rng.randn(n, 8)
    groups = []
    for _ in range(4):
        which = rng.randint(0, 7, n)          # 6: none of the group
        g = np.zeros((n, 6))
        on = which < 6
        g[np.nonzero(on)[0], which[on]] = rng.randint(1, 9, on.sum())
        groups.append(g)
    X = np.concatenate([dense] + groups, axis=1)
    score = (dense[:, 0] + 0.5 * dense[:, 1] * dense[:, 2]
             + sum(0.15 * g[:, k] * (k - 2.5) for g in groups
                   for k in range(6)) + 0.5 * rng.randn(n))
    y = (score > 0).astype(np.float64)
    base = {"objective": "binary", "metric": ["auc"], "num_leaves": 15,
            "learning_rate": 0.1, "verbose": -1}
    for name, extra in (("f32", {}), ("quantized", {
            "use_quantized_grad": True, "num_grad_quant_bins": 16})):
        k1, k2 = hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches
        out = card_vs_cpu({**base, **extra}, X[:180_000], y[:180_000],
                          X[180_000:], y[180_000:], 10)
        lr = out["cuda"][4]._booster.learner
        check(lr.bundle is not None, "T7: no EFB bundle formed")
        C, F_ = lr.x_rows.shape[1], lr.num_features
        check(C < F_, f"T7: {C} bundled columns for {F_} features")
        used = (hc.HIST_LAUNCHES.launches - k1 if name == "f32"
                else hc.HIST_Q_LAUNCHES.launches - k2)
        check(used > 0, f"T7 [{name}] launched no histogram kernel")
        (pc, bc, ac, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        print(f"T7 EFB [{name}]: {F_} features in {C} bundled columns; "
              f"{'K1' if name == 'f32' else 'K2'} launches {used}; card == "
              f"CPU predictions max |diff| {np.abs(pc - pp).max():.3g}, "
              f"best_iteration {bc}, valid AUC {ac:.5f}; train {sc:.1f} s "
              f"on the card, {sp:.1f} s on the CPU [{smi}]")


def serve_trained_phase(bst, Xva, dev, smi: str, tag: str = "T5") -> None:
    import lambdagap_tpu_torch as lgt
    import torch
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    text = bst.model_to_string()
    srv_bst = lgt.Booster(model_str=text)
    gb = srv_bst._booster
    data = np.ascontiguousarray(Xva[:20_000])
    plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
    with srv_bst.as_server(raw_score=True, workers=1) as server:
        answers, secs = burst(server, data, plan)
    forest, depth = forest_to_arrays(gb.models, device=dev)
    oracle = predict_forest(torch.from_numpy(data).to(dev), forest,
                            [0] * len(gb.models), 1, depth)[0].cpu().numpy()
    check_answers(answers, plan, oracle)
    print(f"{tag} served the trained model ({len(gb.models)} trees, "
          f"{len(text) / 1e6:.2f} MB of text): {REQUESTS} requests in "
          f"{secs:.2f} s, each == scan oracle [{smi}]")


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows of phase T3 (HIGGS's count)")
    ap.add_argument("--only", choices=("all", "kernels"), default="all",
                    help="kernels: phases 1-2 (with the SASS check), T2 and "
                    "T2q, then stop without a result line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.infer import (TRAVERSE_LAUNCHES, CompiledForest,
                                           compile_forest)
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.models import synth
    from lambdagap_tpu_torch.ops import hist_cuda
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    from lambdagap_tpu_torch.utils import cuda_build
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- 1. the card and the software --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc_v = subprocess.run([cuda_build.nvcc(), "--version"],
                            capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_v}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build every kernel of the path, in parallel ---------------------
    t0 = time.perf_counter()
    sources = [eng.TRAVERSE_SOURCE, hist_cuda.HIST_SOURCE,
               hist_cuda.HIST_Q_SOURCE]
    handles = [cuda_build.start_build(s) for s in sources]
    for s, h in zip(sources, handles):
        report = cuda_build.finish_build(h)
        regs = [ln.split("info    :", 1)[-1].strip()
                for ln in report.splitlines()
                if "Compiling entry" in ln or "registers" in ln
                or "spill" in ln]
        print(f"built {s}: " + ("; ".join(regs) if regs else "(cached)"))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    sass_phase()
    if args.only == "kernels":
        hist_phase(dev, args.seed + 11, smi)
        hist_q_phase(dev, args.seed + 12, smi)
        print("chip_smoke: kernel phases passed (--only kernels: no result)")
        return 0

    # -- 3. the HIGGS-width forest, round-tripped through text --------------
    t0 = time.perf_counter()
    trees = synth.random_trees(args.seed, T, LEAVES, F, GRID)
    text = booster_from_numpy(synth.header(F), trees,
                              {"device_type": "cpu"}).model_to_string()
    host = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    check(host.model_to_string() == text, "text round trip not byte-stable")
    gb = host._booster
    check(len(gb.models) == T and all(t.num_leaves == LEAVES
                                      for t in gb.models),
          "forest shape after the text round trip")
    art = compile_forest(gb)
    m = art.meta
    print(f"forest: {T} trees x {LEAVES} leaves x {F} features, text "
          f"{len(text) / 1e6:.1f} MB; artifact groups {m['num_groups']}, "
          f"blocks {m['num_blocks']}, nodes {len(art.buffers['node_feat'])}"
          f" (pruned {m['nodes_pruned']}), thr_bits {m['thr_bits']}, "
          f"{art.nbytes / 1e6:.2f} MB, sha256 {art.hash[:16]} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(m["thr_bits"] == 16, "the 254-boundary grid needs u16 codes")

    # -- 4. the kernel against its plain version ----------------------------
    rng = np.random.RandomState(args.seed + 7)
    cf = CompiledForest(art, dev)
    tables = cf.tables
    max_err = 0
    for n in (1, 8, 601, 4096):
        x = torch.from_numpy(synth.random_rows(rng, n, F)).to(dev)
        got = eng.traverse_forest(x, tables)
        ref = eng._traverse_all_reference(x, tables)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and torch.equal(got, ref),
              f"kernel != plain traversal at {n} rows "
              f"({int((got != ref).sum())} entries differ)")
        check(bool((got < 0).all()), f"non-leaf carry at {n} rows")
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
        print(f"kernel == plain at {n} rows x {got.shape[1]} groups "
              f"({len(tables.depths)} node blocks)")
    cfeats = 6
    ctrees = synth.categorical_trees(args.seed + 1, num_features=cfeats)
    ctext = booster_from_numpy(synth.header(cfeats), ctrees,
                               {"device_type": "cpu"}).model_to_string()
    cgb = lgt.Booster(model_str=ctext, params={"device_type": "cpu"})._booster
    cart = compile_forest(cgb)
    check(cart.meta["cat_words"] >= 3, "70 categories need 3 bitset words")
    ctab = CompiledForest(cart, dev).tables
    for n in (8, 601, 4096):
        x = torch.from_numpy(synth.hostile_rows(rng, n, cfeats)).to(dev)
        got = eng.traverse_forest(x, ctab)
        ref = eng._traverse_all_reference(x, ctab)
        torch.cuda.synchronize()
        check(torch.equal(got, ref),
              f"kernel != plain traversal on the categorical forest at {n} "
              "rows")
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
    print("kernel == plain on the 70-category forest with hostile values")
    print(f"kernel launches in the comparisons: {TRAVERSE_LAUNCHES.launches}"
          " (not counted below)")

    x4k = torch.from_numpy(synth.random_rows(rng, 4096, F)).to(dev)
    carry = eng.traverse_forest(x4k, tables)
    steps = steps_taken(art, carry.cpu().numpy())
    bound_ms, bound_by, nbytes = kernel_bound(x4k, tables, carry.shape, steps)
    k_ms = cuda_ms(lambda: eng.traverse_forest(x4k, tables))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def cold():
        flush.fill_(1)                    # evict L2 (50 MB) first
        eng.traverse_forest(x4k, tables)
    k_cold_ms = cuda_ms(cold) - cuda_ms(lambda: flush.fill_(1))
    p_ms = cuda_ms(lambda: eng._traverse_all_reference(x4k, tables), reps=20)
    print(f"traverse @4096 rows x {carry.shape[1]} groups: kernel "
          f"{k_ms:.4f} ms (L2 warm), {k_cold_ms:.4f} ms (L2 flushed), "
          f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {steps} decision steps) [{smi}]")
    vals = eng._leaf_values(carry, cf._group_of_tree, cf._leaf_value)
    acc_ms = wall_ms(lambda: eng._accumulate(vals, cf._tree_class, 1, 0,
                                             0.0))
    acc1_ms = wall_ms(lambda: eng._accumulate(vals[:1], cf._tree_class, 1,
                                              0, 0.0))
    print(f"forest-order accumulation ({T} adds): {acc_ms:.3f} ms @4096 "
          f"rows, {acc1_ms:.3f} ms @1 row (host wall incl. sync) [{smi}]")
    for b in (1, 64, 4096):
        xb = x4k[:b].contiguous()
        print(f"CompiledForest.predict @{b} rows: "
              f"{wall_ms(lambda: cf.predict(xb)):.3f} ms (host wall incl. "
              f"sync) [{smi}]")

    # -- 5. the main path ----------------------------------------------------
    data = synth.random_rows(rng, 20000, F)
    TRAVERSE_LAUNCHES.reset()
    bst = lgt.Booster(model_str=text, params={"predict_engine": "compiled"})
    server = bst.as_server(raw_score=True)
    check(server.cache.device.type == "cuda", "server not on the card")
    plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
    answers, serve_s = burst(server, data, plan)
    snap = server.stats_snapshot()
    conv = bst.predict(data[:4096])
    server.close()
    launches = TRAVERSE_LAUNCHES.launches
    check(launches > 0, "the main path never launched the traversal kernel")

    xall = torch.from_numpy(data).to(dev)
    forest, depth = forest_to_arrays(gb.models, device=dev)
    oracle = predict_forest(xall, forest, [0] * T, 1, depth)[0].cpu().numpy()
    check_answers(answers, plan, oracle)
    check(np.all(np.isfinite(oracle)), "non-finite scores")
    sig = 1.0 / (1.0 + np.exp(-oracle[:4096].astype(np.float64)))
    check(np.allclose(conv, sig, rtol=1e-6, atol=1e-7),
          "converted predict != sigmoid of the oracle")
    check(snap["requests"] == len(plan), "stats lost requests")
    lat = snap["latency_ms"]
    print(f"serve: {snap['requests']} requests, {snap['rows']} rows from 4 "
          f"threads in {serve_s:.2f} s, each == scan oracle; latency p50 "
          f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms; "
          f"{snap['throughput_rows_per_s']:.0f} rows/s; "
          f"{snap['batches']['count']} batches; kernel launches {launches} "
          f"[{smi}]")

    # -- 5b. the same burst per worker count; closed-loop one-row latency ----
    for workers in (1, 4):
        with bst.as_server(raw_score=True, workers=workers) as srv:
            got, secs = burst(srv, data, plan)
            check_answers(got, plan, oracle)
            one = []
            for i in range(100):
                t0 = time.perf_counter()
                srv.predict(data[i])
                one.append((time.perf_counter() - t0) * 1e3)
        one.sort()
        print(f"serve workers={workers}: burst {sum(n for _, n in plan) / secs:.0f}"
              f" rows/s ({secs:.2f} s); one-row closed loop p50 "
              f"{one[49]:.3f} ms p99 {one[98]:.3f} ms [{smi}]")

    # -- T2. the histogram kernels against their plain versions -------------
    t0 = time.perf_counter()
    k1 = hist_phase(dev, args.seed + 11, smi)
    k2 = hist_q_phase(dev, args.seed + 12, smi)
    print(f"T2+T2q: {time.perf_counter() - t0:.1f} s")

    # -- T3. the f32 training path (counts zeroed just before, read after) ---
    t0 = time.perf_counter()
    t3 = train_phase(args, smi)
    print(f"T3: {time.perf_counter() - t0:.1f} s")

    # -- T6. the quantized, bagged path on T3's Datasets ---------------------
    t0 = time.perf_counter()
    bst6, k2_launches = quant_phase(t3, smi)
    serve_trained_phase(bst6, t3["Xva"], dev, smi, tag="T6")
    print(f"T6: {time.perf_counter() - t0:.1f} s")

    # -- T4. card against CPU; T5. serve what T3 trained; T7. EFB ------------
    t0 = time.perf_counter()
    card_vs_cpu_phase()
    serve_trained_phase(t3["bst"], t3["Xva"], dev, smi)
    print(f"T4+T5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    efb_phase(smi)
    print(f"T7: {time.perf_counter() - t0:.1f} s")

    # -- 6. the kernels line, then the device line ---------------------------
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "traverse_forest", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:68",
        "launches": launches, "max_abs_err": float(max_err),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "hist_rows", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:79",
        "launches": t3["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "hist_rows_q", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist_q.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:207",
        "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
