#!/usr/bin/env python3
"""Compare the port's serve dispatch between two checkouts on one card.

    python3 dispatch_ab.py TREE_A TREE_B [--pairs N] [--seed N] [--out F]

Each TREE is a directory holding a ``lambdagap_tpu_torch`` package (the
root of a checkout, or a copy with one constant edited). One worker
process per tree builds the same seeded HIGGS-width forest as
``chip_smoke.py`` phase 3 (binary, 28 features, 500 trees of 255 leaves),
compiles it, and waits. The parent then asks the two workers for a round
each, in the order A B, B A, A B, ... (``--pairs`` pairs), so a drift of
the card or the host falls on both alike. A round reads:

- ``dispatch_ms``: the median host wall of ``CompiledForest.predict`` on
  rows already on the card, ended by a device synchronize, at 1, 64 and
  512 rows (20 calls each);
- ``one_row_p50_ms``: the p50 of 50 one-row ``server.predict`` calls in a
  closed loop, one worker, the default batch window;
- ``one_row_nodelay_p50_ms``: the same with a zero batch window.

Printed: the card's name and power limit, each round as a JSON line, and
last one JSON summary: per metric each tree's median over its rounds, the
median of the paired differences B - A, and the pairs in which B was
faster. Needs one card; imports nothing of JAX nor of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SIZES = (1, 64, 512)
F, T, LEAVES, GRID = 28, 500, 255, 254


def worker(tree: str, seed: int) -> int:
    """Build the forest from the package under ``tree`` and answer one
    round of readings per ``go`` line on stdin, until ``quit``."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
    from lambdagap_tpu_torch.models import synth
    if not torch.cuda.is_available():
        print("dispatch_ab: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    trees = synth.random_trees(seed, T, LEAVES, F, GRID)
    text = booster_from_numpy(synth.header(F), trees,
                              {"device_type": "cpu"}).model_to_string()
    host = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    cf = CompiledForest(compile_forest(host._booster), dev)
    rows = synth.random_rows(np.random.RandomState(seed + 7), 4096, F)
    xs = {n: torch.from_numpy(rows[:n]).to(dev) for n in SIZES}
    bst = lgt.Booster(model_str=text, params={"predict_engine": "compiled"})
    servers = {"one_row_p50_ms": bst.as_server(raw_score=True, workers=1),
               "one_row_nodelay_p50_ms": bst.as_server(
                   raw_score=True, workers=1, max_delay_ms=0.0)}

    def dispatch_ms(x) -> float:
        times = []
        for i in range(22):
            t0 = time.perf_counter()
            cf.predict(x)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def closed_loop_p50(server) -> float:
        times = []
        for i in range(52):
            t0 = time.perf_counter()
            server.predict(rows[i])
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for n in SIZES:                      # build, load and warm both paths
        cf.predict(xs[n])
    for server in servers.values():
        closed_loop_p50(server)
    torch.cuda.synchronize()
    print(json.dumps({"ready": tree}), flush=True)
    for line in sys.stdin:
        if line.strip() != "go":
            break
        reading = {"dispatch_ms": {str(n): dispatch_ms(xs[n])
                                   for n in SIZES}}
        reading.update({k: closed_loop_p50(s) for k, s in servers.items()})
        print(json.dumps(reading), flush=True)
    for server in servers.values():
        server.close()
    return 0


def _json_line(proc, arm: str) -> dict:
    """The worker's next JSON line; its log lines are passed through."""
    for line in proc.stdout:
        if line.startswith("{"):
            return json.loads(line)
        sys.stderr.write(line)
    raise SystemExit(f"dispatch_ab: worker {arm} ended early")


def _metrics(reading: dict) -> dict:
    flat = {f"dispatch_ms@{n}": v
            for n, v in reading["dispatch_ms"].items()}
    flat.update({k: v for k, v in reading.items() if k != "dispatch_ms"})
    return flat


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", metavar="TREE")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the rounds and summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.seed)
    if len(args.trees) != 2:
        ap.error("give two trees, A and B")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    procs = {}
    try:
        for arm, tree in zip("AB", args.trees):
            procs[arm] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 "--seed", str(args.seed)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
        for arm, p in procs.items():
            _json_line(p, arm)           # {"ready": tree}
        rounds = {"A": [], "B": []}
        for i in range(args.pairs):
            for arm in ("AB" if i % 2 == 0 else "BA"):
                p = procs[arm]
                p.stdin.write("go\n")
                p.stdin.flush()
                reading = _json_line(p, arm)
                rounds[arm].append(reading)
                print(json.dumps({"pair": i, "tree": arm, **reading}),
                      flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.stdin.write("quit\n")
                p.stdin.close()
        for p in procs.values():
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
    a = [_metrics(r) for r in rounds["A"]]
    b = [_metrics(r) for r in rounds["B"]]
    summary = {"card": smi, "trees": {"A": args.trees[0],
                                      "B": args.trees[1]},
               "pairs": args.pairs, "metrics": {}}
    for key in a[0]:
        diffs = [y[key] - x[key] for x, y in zip(a, b)]
        summary["metrics"][key] = {
            "A_median": statistics.median(x[key] for x in a),
            "B_median": statistics.median(y[key] for y in b),
            "B_minus_A_median": statistics.median(diffs),
            "B_faster_pairs": sum(d < 0 for d in diffs)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rounds": rounds, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
