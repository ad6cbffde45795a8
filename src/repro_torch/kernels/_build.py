"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/repro_torch/lib<name>.so`` at the repository root
(a directory ``.gitignore`` lists), for ``sm_90a`` only. A library is
rebuilt when its source or any ``csrc/*.cuh`` header is newer.

The slot split (``serve/placement.py``) renders on several devices from
several host threads, so a library's first load takes a lock.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_LOAD_LOCK = threading.Lock()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def compile_library(name: str, csrc: Path = CSRC,
                    out: Optional[Path] = None) -> Tuple[float, str]:
    """Compile ``<csrc>/<name>.cu`` (into ``out``, by default the package's
    build directory); returns (seconds, nvcc's ptxas report)."""
    src = csrc / f"{name}.cu"
    out = library_path(name) if out is None else out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return seconds, proc.stdout + proc.stderr


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (looked on PATH and in "
                       "/usr/local/cuda/bin)")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so``, compiling it first if missing or stale."""
    src, out = CSRC / f"{name}.cu", library_path(name)
    with _LOAD_LOCK:
        newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
        if not out.exists() or out.stat().st_mtime < newest:
            compile_library(name)
        return ctypes.CDLL(str(out))

