"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  Libraries go to
``go_raytracing_tpu_torch/_build/`` (not tracked by git) under a name that
carries a hash of every file in ``csrc/`` and of the compiler flags, so a
changed source rebuilds and an unchanged one is reused.  A failed build
raises with the compiler's output; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was reused
    registers: int         # most registers a thread of any kernel uses
    spill_bytes: int       # spill stores + loads, summed over kernels
    log: str               # nvcc / ptxas output


_loaded: dict = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and in "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


def _sources_hash(flags) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC_DIR.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _ptxas_stats(log: str):
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return (max(regs) if regs else -1), sum(spills)


def load(name: str, fmad: bool = False) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``.

    The default build passes ``-fmad=false``: nvcc then does not contract
    a*b+c into one fused multiply-add, and the kernel repeats the rounding
    of its plain PyTorch version (whose elementwise kernels never fuse
    across operations).  Measured on an H100, the forward wavefront kernel
    then equals its plain version ray for ray, while the contracted build
    sends 0.6 % of Cornell rays down another branch: the reference's
    self-intersection epsilon (1e-3 in a 555-unit box) sits a few ulp from
    the rounding noise of a grazing ray's own wall.  ``fmad=True`` builds
    the contracted variant, which the GPU check times beside it."""
    key = (name, fmad)
    if key in _loaded:
        return _loaded[key]
    flags = NVCC_FLAGS + ["-fmad=true" if fmad else "-fmad=false"]
    src = CSRC_DIR / f"{name}.cu"
    tag = _sources_hash(flags)
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    log_path = BUILD_DIR / f"lib{name}_{tag}.log"
    seconds = 0.0
    if not so.exists():
        tmp = BUILD_DIR / f"lib{name}_{tag}.{os.getpid()}.tmp.so"
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)  # atomic: concurrent builders agree on one file
    log = log_path.read_text() if log_path.exists() else ""
    regs, spills = _ptxas_stats(log)
    built = Built(ctypes.CDLL(str(so)), so, seconds, regs, spills, log)
    _loaded[key] = built
    return built
