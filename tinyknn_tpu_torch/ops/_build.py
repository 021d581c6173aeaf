"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
whose file name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), under ``_build/`` beside this package's sources, and
loaded with ``ctypes``. A changed source or header builds to a new path;
an unchanged one is loaded from the last build.
Nothing is compiled when the package is imported, and a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("scan_fold_csr", "scan_exact_csr", "estimate_scan_tiled")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Build(NamedTuple):
    """A loaded kernel library and how it was made."""
    lib: ctypes.CDLL
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc's output (the -Xptxas -v resource lines)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME)")


@functools.cache
def build(name: str) -> Build:
    """Compile (if needed) and load ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                           capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders both succeed
    return Build(ctypes.CDLL(str(so)), so, seconds, log)


def build_all(names=KERNELS) -> dict[str, Build]:
    """``build`` several sources at once: one nvcc process each, all
    started together. Returns {name: Build}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))
