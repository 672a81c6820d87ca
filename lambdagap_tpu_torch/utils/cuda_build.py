"""Build and load the port's hand-written CUDA kernels.

Each source under ``lambdagap_tpu_torch/csrc/`` has a plain C interface
and is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library,
loaded with ``ctypes``. Nothing is built at import: :func:`load` builds on
first use (the CPU tests never reach it), and ``chip_smoke.py`` starts one
``nvcc`` per source at once (:func:`start_build`, :func:`finish_build`).
Libraries land in ``build/kernels/`` beside the package (git-ignored),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source never loads a stale build and a second
process reuses the first one's. :func:`sass_atomics` lists the atomic
instructions a built library holds (``cuobjdump -sass``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from . import log

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no --use_fast_math: the kernels' NaN and zero-threshold tests must
# survive compilation exactly
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by the
    source, the shared headers it may include and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def start_build(source: str):
    """Start ``nvcc`` on ``csrc/<source>`` without waiting. Returns None
    when the library already exists, else a handle for :func:`finish_build`
    (so several sources compile at once)."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd: List[str] = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(handle) -> str:
    """Wait for a :func:`start_build` handle; returns the compiler's
    output (``-Xptxas -v`` register and spill report). Raises
    RuntimeError with that output when the build fails."""
    if handle is None:
        return ""
    proc, tmp, out = handle
    text, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{out.name}:\n{text}")
    os.replace(tmp, out)
    return text


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if its library is missing, then load it.
    The caller keeps the handle (and serializes its first call)."""
    report = finish_build(start_build(source))
    if report:
        log.debug("nvcc %s:\n%s", source, report)
    return ctypes.CDLL(str(library_path(source)))


def sass_atomics(source: str) -> Dict[str, int]:
    """Count of each atomic / reduction opcode (``ATOM*``, ``RED*``) in the
    SASS of ``csrc/<source>``'s built library, from ``cuobjdump -sass``
    beside nvcc. A CAS opcode there means an atomic was compiled as a
    compare-and-swap loop."""
    tool = Path(nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    ops = Counter()
    for line in text.splitlines():
        words = line.split("*/", 1)[-1].split()
        if words and words[0].startswith("@"):       # a predicate
            words = words[1:]
        if words and words[0].startswith(("ATOM", "RED")):
            ops[words[0].rstrip(";")] += 1
    return dict(ops)
