#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed N] [--rows N]

Run from the root of a checkout. Phases, each fatal on failure:

1. the card (name and power limit, as nvidia-smi reports them) and the
   torch / CUDA / nvcc versions;
2. build every kernel of both paths from ``lambdagap_tpu_torch/csrc/``
   (traverse.cu and hist.cu: one nvcc per source, all started together)
   into the git-ignored build dir;
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
T2. the histogram kernel against its plain version on the card at four
   shapes (the HIGGS root, a leaf behind a permutation slice with
   out-of-range junk past ``count``, u16 bins with a ragged count, count
   0): the count channel ``torch.equal``, grad/hess within rtol 2e-3 /
   atol 1e-4, a rerun ``torch.equal`` to the first run; then the kernel's,
   the plain version's and ``index_add_``'s times and the bound;
T3. the training path: ``lgt.train`` on the card, binary, HIGGS width (28
   features, ``num_leaves=255``, ``max_bin=255``), ``--rows`` seeded
   synthetic rows (10,500,000, HIGGS's count, by default) plus a 500,000-row
   validation set, 10 rounds with ``early_stopping(5)``; the launch counts
   are zeroed just before and read just after, and the histogram launches
   must equal the leaf histograms the learner built;
T4. the example shape (16,000 x 20, 63 leaves, 30 rounds, validation set,
   early stopping) trained on the card and on the CPU: predictions on the
   training rows within rtol 1e-4 / atol 1e-5, ``best_iteration`` equal;
T5. the T3 model through ``model_to_string`` -> ``Booster(model_str=)`` ->
   ``as_server(raw_score=True)``: a burst, each answer ``array_equal`` to
   the scan oracle on the card;
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
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
# T2: the histogram kernel against its plain version
# ---------------------------------------------------------------------------
def hist_bound(bins, rows, count: int, num_bins: int):
    """Least time for hist_rows: each live row's bins, grad and hess (and
    its row id when there is a row list) read once, the [F, B, 3] result
    written once; three f32 adds per (row, feature)."""
    F_ = bins.shape[1]
    nbytes = (count * (F_ * bins.element_size() + 8
                       + (4 if rows is not None else 0))
              + F_ * num_bins * 3 * 4)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = count * F_ * 3 / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def index_add_call(bins, grad, hess, rows, count: int, num_bins: int):
    """One ``index_add_`` that computes the same histogram from the
    gathered [count * F, 3] channels (timed only; the port never calls
    it)."""
    import torch
    dev = bins.device
    r = (torch.arange(count, device=dev) if rows is None
         else rows[:count].long())
    b = (bins.int() if bins.dtype == torch.uint16 else bins)[r].long()
    F_ = bins.shape[1]
    idx = (b + torch.arange(F_, device=dev) * num_bins).reshape(-1)
    ch = torch.stack([grad[r], hess[r], torch.ones_like(grad[r])], 1)
    vals = ch[:, None, :].expand(count, F_, 3).reshape(-1, 3).contiguous()
    out = torch.zeros((F_ * num_bins, 3), dtype=torch.float32, device=dev)
    return lambda: out.zero_().index_add_(0, idx, vals)


def hist_phase(dev, seed: int, smi: str) -> dict:
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = HIGGS_ROWS
    bins = torch.randint(0, MAX_BIN, (N, F), generator=gen, device=dev,
                         dtype=torch.uint8)
    grad = torch.randn(N, generator=gen, device=dev)
    hess = torch.rand(N, generator=gen, device=dev) * 0.25
    leaf = N // 255
    # a leaf's slice of a permutation, then ids no row has: the kernel
    # must never read through a position past count
    leaf_rows = torch.randperm(N, generator=gen, device=dev)[:2 * leaf].int()
    leaf_rows[leaf:] = 2 ** 31 - 1
    n16 = 100_003
    bins16 = torch.randint(0, 1024, (n16, 8), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint16)
    g16 = torch.randn(n16, generator=gen, device=dev)
    h16 = torch.rand(n16, generator=gen, device=dev)
    rows16 = torch.randperm(n16, generator=gen, device=dev)[:90_000].int()

    def one(v: int):
        """A count on the device: the launch reads it there."""
        return torch.tensor([v], dtype=torch.int32, device=dev)

    cases = [
        ("a: HIGGS root, 28 u8 features, all rows",
         (bins, grad, hess, None, N, 256), N),
        ("b: a leaf, N/255 rows via a permutation slice, junk past count",
         (bins, grad, hess, leaf_rows, one(leaf), 256), leaf),
        ("c: u16 bins, 1024 bins x 8 features, ragged count",
         (bins16, g16, h16, rows16, 77_777, 1024), 77_777),
        ("d: count = 0", (bins, grad, hess, leaf_rows, one(0), 256), 0),
    ]
    max_err = 0.0
    timed = {}
    for name, args, count in cases:
        got = hc.hist_rows(*args)
        again = hc.hist_rows(*args)
        ref = hc._hist_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K1 rerun not bit-identical ({name})")
        check(torch.equal(got[..., 2], ref[..., 2]),
              f"K1 count channel != plain ({name})")
        check(torch.allclose(got[..., :2], ref[..., :2], rtol=2e-3,
                             atol=1e-4), f"K1 grad/hess != plain ({name})")
        check(int(got[..., 2].double().sum()) == count * args[0].shape[1],
              f"K1 counted rows wrongly ({name})")
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        print(f"K1 == plain [{name}]: counts equal, max |err| {err:.3g}, "
              "rerun bit-identical")
        if name[0] in "ab":
            k_ms = cuda_ms(lambda: hc.hist_rows(*args))
            p_ms = cuda_ms(lambda: hc._hist_reference(*args), reps=3, warm=1)
            lib = index_add_call(args[0], args[1], args[2], args[3], count,
                                 args[5])
            l_ms = cuda_ms(lib, reps=5, warm=1)
            del lib
            bound, by, nbytes = hist_bound(args[0], args[3], count, args[5])
            timed[name[0]] = (k_ms, p_ms, l_ms, bound, by)
            print(f"K1 [{name}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                  f"index_add_ {l_ms:.3f} ms, bound {bound:.4f} ms ({by}: "
                  f"{nbytes / 1e6:.1f} MB) [{smi}]")
    print(f"K1 launches in the comparisons: {hc.HIST_LAUNCHES.launches} "
          "(not counted below)")
    del bins, grad, hess, leaf_rows
    torch.cuda.empty_cache()
    k_ms, p_ms, l_ms, bound, by = timed["a"]
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": max_err,
            "leaf_ms": timed["b"][0]}


# ---------------------------------------------------------------------------
# T3-T5: training on the card, card against CPU, serving what was trained
# ---------------------------------------------------------------------------
def train_phase(args, smi: str):
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.infer import TRAVERSE_LAUNCHES
    from lambdagap_tpu_torch.ops.hist_cuda import HIST_LAUNCHES
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
    return bst, Xva, launches


def card_vs_cpu_phase() -> None:
    import lambdagap_tpu_torch as lgt
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": 63, "learning_rate": 0.1, "verbose": -1}
    out = {}
    for device in ("cuda", "cpu"):
        tr = lgt.Dataset(X[:16_000], label=y[:16_000])
        va = lgt.Dataset(X[16_000:], label=y[16_000:], reference=tr)
        t0 = time.perf_counter()
        bst = lgt.train({**params, "device_type": device}, tr, 30,
                        valid_sets=[va],
                        callbacks=[lgt.early_stopping(5, verbose=False)])
        out[device] = (bst.predict(X[:16_000]), bst.best_iteration,
                       time.perf_counter() - t0)
    (pc, bc, sc), (pp, bp, sp) = out["cuda"], out["cpu"]
    # training rows: thresholds tied across bins that hold no training row
    # may break either way between the kernel's f32 sums and the plain
    # version's f64 sums; they route no training row differently
    check(np.allclose(pc, pp, rtol=1e-4, atol=1e-5),
          f"card != CPU predictions (max |diff| {np.abs(pc - pp).max()})")
    check(bc == bp, f"best_iteration card {bc} != CPU {bp}")
    print(f"T4 card == CPU: predictions max |diff| "
          f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}; train "
          f"{sc:.1f} s on the card, {sp:.1f} s on the CPU")


def serve_trained_phase(bst, Xva, dev, smi: str) -> None:
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
    print(f"T5 served the trained model ({len(gb.models)} trees, "
          f"{len(text) / 1e6:.2f} MB of text): {REQUESTS} requests in "
          f"{secs:.2f} s, each == scan oracle [{smi}]")


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows of phase T3 (HIGGS's count)")
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
    sources = [eng.TRAVERSE_SOURCE, hist_cuda.HIST_SOURCE]
    handles = [cuda_build.start_build(s) for s in sources]
    for s, h in zip(sources, handles):
        report = cuda_build.finish_build(h)
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {s}: " + ("; ".join(regs[:4]) if regs
                                else "(cached)"))
    print(f"build: {time.perf_counter() - t0:.2f} s")

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

    # -- T2. the histogram kernel against its plain version -----------------
    t0 = time.perf_counter()
    k1 = hist_phase(dev, args.seed + 11, smi)
    print(f"T2: {time.perf_counter() - t0:.1f} s")

    # -- T3. the training path (counts zeroed just before, read just after) --
    t0 = time.perf_counter()
    bst, Xva, k1_launches = train_phase(args, smi)
    print(f"T3: {time.perf_counter() - t0:.1f} s")

    # -- T4. card against CPU; T5. serve what was trained -------------------
    t0 = time.perf_counter()
    card_vs_cpu_phase()
    serve_trained_phase(bst, Xva, dev, smi)
    print(f"T4+T5: {time.perf_counter() - t0:.1f} s")

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
        "launches": k1_launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
