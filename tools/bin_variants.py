"""Time variants of kernel B (``lambdagap_tpu_torch/csrc/bin.cu``) on the card.

Each variant is the committed source with text substitutions, or a launch
plan restricted to some row-tile heights / row groups; all are built with
the port's nvcc flags and timed in one process on the same rows, in turns
(the card's speed varies between machines, so only times from one run
compare). Shapes: T3's 10,500,000 x 28 and T8's 2,266,357 x 136 float32
rows of a seeded normal, bins from a 200,000-row sample at max_bin 255;
beside each, its bytes bound and one batched ``torch.searchsorted``.

    python3 tools/bin_variants.py tools/bin_variants.json

The JSON maps a variant name to ``{"subs": [[old, new], ...], "rows":
[...], "groups": [...]}`` (every key optional). A variant that changes
what B computes prints ``equal False``: such variants measure the cost of
a part of the kernel, not a candidate.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def device_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` behind a device sleep."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e8))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def build(variants: dict, src: str, out_dir: str) -> dict:
    """Every variant's library, built in parallel, declared."""
    from lambdagap_tpu_torch.ops import bin_cuda as bc
    from lambdagap_tpu_torch.utils import cuda_build as cb
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, v) in enumerate(variants.items()):
        text = src
        for old, new in v.get("subs", []):
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {bc.BIN_SOURCE}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"variant{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"variant{i}.so")
        procs[name] = (subprocess.Popen(
            [cb.nvcc(), *cb.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{report}")
        lines = report.splitlines()
        at = [i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and "IfhE" in ln]
        regs = " | ".join(ln.split(":", 1)[-1].strip()
                          for ln in lines[at[0] + 1:at[0] + 3]) if at else ""
        print(f"built {name} (float32 -> u8: {regs})", flush=True)
        libs[name] = bc._declare(ctypes.CDLL(os.path.abspath(lib)))
    return libs


def main() -> int:
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.data.dataset import BinnedDataset
    from lambdagap_tpu_torch.ops import bin_cuda as bc
    if not torch.cuda.is_available():
        print("bin_variants: no CUDA device visible", file=sys.stderr)
        return 1
    variants = json.load(open(sys.argv[1]))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    with open(os.path.join(root, "lambdagap_tpu_torch", "csrc",
                           bc.BIN_SOURCE)) as f:
        src = f.read()
    libs = build(variants, src, os.path.join(root, "build", "bin_variants"))
    defaults = (bc._TILE_ROWS, bc._GROUPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)

    def use(name: str) -> None:
        v = variants[name]
        bc._lib = libs[name]
        bc._devices.clear()
        bc._TILE_ROWS = tuple(v.get("rows", defaults[0]))
        bc._GROUPS = tuple(v.get("groups", defaults[1]))

    for n, f in ((10_500_000, 28), (2_266_357, 136)):
        sample = np.random.default_rng(0).standard_normal(
            (200_000, f), dtype=np.float32)
        table = BinnedDataset.from_matrix(sample, lgt.Config.from_params(
            {"max_bin": 255, "verbose": -1,
             "device_type": "cpu"})).bin_table()
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = torch.randn((n, f), generator=gen, device=dev)
        out = torch.zeros((n, table.num_used), dtype=table.torch_dtype,
                          device=dev)
        ref = bc._bin_reference(x, table, out.clone())
        t = table.on(dev)
        sizes = np.diff(table.off)
        padded = torch.full((table.num_features, int(sizes.max())),
                            float("inf"), dtype=torch.float64, device=dev)
        for i, (lo, hi) in enumerate(zip(table.off[:-1], table.off[1:])):
            padded[i, :hi - lo] = t["bounds"][lo:hi]
        xt = x[:, t["col"].long()].double().t().contiguous()
        lib_ms = device_ms(lambda: torch.searchsorted(padded, xt), reps=3)
        del xt, padded
        bound = (x.numel() * 4 + out.numel() + table.bounds.nbytes) \
            / 3.35e12 * 1e3
        print(f"{n} x {f}: bound {bound:.4f} ms (bytes), batched "
              f"torch.searchsorted {lib_ms:.3f} ms [{smi}]", flush=True)
        times, plans, same = {}, {}, {}
        for turn in range(2):
            for name in (list(libs) if turn == 0 else list(reversed(libs))):
                use(name)
                table._dev.clear()
                got = bc.bin_rows(x, table, out.clone())
                torch.cuda.synchronize()
                same[name] = torch.equal(got, ref)
                plans[name] = {k: w for k, w in table.on(dev)["plans"][
                    4].items() if not isinstance(w, torch.Tensor)}
                times.setdefault(name, []).append(
                    device_ms(lambda: bc.bin_rows(x, table, out)))
        for name, (a, b) in times.items():
            print(f"  {name}: {a:.4f} / {b:.4f} ms, equal {same[name]}, "
                  f"plan {plans[name]}", flush=True)
        del x, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
