"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles ``gnuais_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface under ``build/gnuais_tpu_torch/``
at the repository root (listed in ``.gitignore``), cached by a hash of
the sources and flags, and ``ctypes`` loads it.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gnuais_tpu_torch"

# --fmad=false: no multiply-add contraction, so the FIR rounds like the
# exact chain; no --use_fast_math, whose flush-to-zero would change it
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point in the library
_ENTRIES = {
    "gnuais_pipeline_compact": [_P] * 13 + [_I] * 7 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_log = ""   # compiler output of the last build in this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def build(verbose: bool = False) -> Path:
    """Compile the kernels (unless the library for these sources is
    cached) and return the library's path.  ``verbose`` adds ``-Xptxas
    -v`` (registers, spills) to a fresh build; the compiler's output is
    kept in ``build_log``."""
    global build_log
    cu, cuh = _sources()
    # -Xptxas -v changes the compiler's report, not the library
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / "libgnuais_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib.{os.getpid()}.so"
    cmd = [nvcc_path(), *flags, "-o", str(tmp), *map(str, cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)     # atomic: no reader sees a partial file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
