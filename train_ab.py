#!/usr/bin/env python3
"""Compare the port's tree growing between two checkouts on one card.

    python3 train_ab.py TREE_A TREE_B [--pairs N] [--rows N] [--seed N]
                        [--out F]

Each TREE is a directory holding a ``lambdagap_tpu_torch`` package (the
root of a checkout, or a ``git archive`` of an older commit). One worker
process per tree makes ``chip_smoke.py``'s T3 data (HIGGS width:
10,500,000 x 28 training and 500,000 validation rows, binary, 255 leaves,
255 bins, no tree option) from the same seed and constructs its Datasets,
then waits. The parent asks the two workers for a round each, in the order
A B, B A, A B, ... (``--pairs`` pairs), so a drift of the card or the host
falls on both alike. A round reads:

- ``round_ms``: the median host wall of rounds 2-3 of a fresh 3-round
  ``lgt.train`` with the validation set (evaluation included; round 1
  also pays the booster's set-up and is printed, not compared);
- ``tree_ms``: the host wall of one more tree grown by the learner from
  the booster's gradients, ended by a device synchronize;
- ``histogram_ms``, ``split_scan_ms``, ``partition_ms``: that tree's
  device-stream time between CUDA events around each phase;
- ``host_syncs``: that tree's host reads.

Printed: the card's name and power limit, each round as a JSON line, and
last one JSON summary: per metric each tree's median over its rounds, the
median of the paired differences B - A, and the pairs in which B was
faster. Needs one card; imports nothing of JAX nor of the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROUNDS = 3
HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """``chip_smoke.py`` beside this script: T3's data and constants."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, seed: int, rows: int) -> int:
    """Construct T3's Datasets with the package under ``tree`` and answer
    one round of readings per ``go`` line on stdin, until ``quit``."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import lambdagap_tpu_torch as lgt
    if not torch.cuda.is_available():
        print("train_ab: no CUDA device visible", file=sys.stderr)
        return 1
    smoke = _smoke()
    Xtr, ytr = smoke.higgs_like(seed + 100, rows)
    Xva, yva = smoke.higgs_like(seed + 101, smoke.VALID_ROWS)
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": smoke.LEAVES, "max_bin": smoke.MAX_BIN,
              "learning_rate": 0.1, "verbose": -1}
    cfg = lgt.Config.from_params(params)
    tr = lgt.Dataset(Xtr, label=ytr)
    va = lgt.Dataset(Xva, label=yva, reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    del Xtr

    def reading() -> dict:
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.train(params, tr, ROUNDS, valid_sets=[va],
                        callbacks=[lambda env: marks.append(
                            time.perf_counter())])
        torch.cuda.synchronize()
        walls = np.diff([t0] + marks) * 1e3
        gb = bst._booster
        lr = gb.learner
        lr.time_phases = True
        grad, hess = gb.boosting()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lr.train_device(grad[0], hess[0])
        torch.cuda.synchronize()
        tree_ms = (time.perf_counter() - t1) * 1e3
        lr.time_phases = False
        ph = lr.phase_ms
        return {"round_ms": statistics.median(walls[1:]),
                "tree_ms": tree_ms,
                "histogram_ms": ph.get("histogram", 0.0),
                "split_scan_ms": ph.get("split_scan", 0.0),
                "partition_ms": ph.get("partition", 0.0),
                "host_syncs": lr.host_syncs,
                "rounds_ms": [float(w) for w in walls]}

    reading()                            # build, load and warm the kernels
    print(json.dumps({"ready": tree}), flush=True)
    for line in sys.stdin:
        if line.strip() != "go":
            break
        print(json.dumps(reading()), flush=True)
    return 0


def _json_line(proc, arm: str) -> dict:
    """The worker's next JSON line; its log lines are passed through."""
    for line in proc.stdout:
        if line.startswith("{"):
            return json.loads(line)
        sys.stderr.write(line)
    raise SystemExit(f"train_ab: worker {arm} ended early")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", metavar="TREE")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the rounds and summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.seed, args.rows)
    if len(args.trees) != 2:
        ap.error("give two trees, A and B")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    procs = {}
    try:
        # one worker at a time makes its data: the two would share the
        # host's cores
        for arm, tree in zip("AB", args.trees):
            procs[arm] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 "--seed", str(args.seed), "--rows", str(args.rows)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            _json_line(procs[arm], arm)  # {"ready": tree}
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
    summary = {"card": smi, "trees": {"A": args.trees[0],
                                      "B": args.trees[1]},
               "pairs": args.pairs, "rows": args.rows, "metrics": {}}
    a, b = rounds["A"], rounds["B"]
    for key, v in a[0].items():
        if isinstance(v, list):
            continue
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
