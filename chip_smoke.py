#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, each fatal on failure:

1. the card (name and power limit, as nvidia-smi reports them) and the
   torch / CUDA / nvcc versions;
2. build every kernel of the path from ``lambdagap_tpu_torch/csrc/`` (one
   nvcc per source, all started together) into the git-ignored build dir;
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
5. the main path: ``Booster(model_str=...).as_server(raw_score=True)`` on
   the card answers requests of 1..4096 rows from 4 threads, each answer
   ``array_equal`` to the port's scan oracle on the card; the launch counts
   are zeroed just before and read just after;
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


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    sources = [eng.TRAVERSE_SOURCE]
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

    # -- 6. the kernels line, then the device line ---------------------------
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "traverse_forest", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:68",
        "launches": launches, "max_abs_err": float(max_err),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
