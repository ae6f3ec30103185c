"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles ``gnuais_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface under ``build/gnuais_tpu_torch/``
at the repository root (listed in ``.gitignore``), cached by a hash of
the sources and flags, and ``ctypes`` loads it.  The strip variants of
kernel B2 (``csrc/pipeline_strip.cu``, an instrument) are not in it: each
strip set is a library of its own, built the same way at its first use
(``strip_library``).  Nothing here runs at import time.
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
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point in the library
_ENTRIES = {
    "gnuais_pipeline_compact": [_P] * 13 + [_I] * 10 + [_P],
    "gnuais_pipeline_fused": [_P] * 13 + [_I] * 10 + [_P],
    "gnuais_pipeline_shape": [_I, _P],
    "gnuais_frontend": [_P] * 5 + [_I] * 4 + [_P],
    "gnuais_dpll": [_P] * 4 + [_I] * 4 + [_P],
    "gnuais_hdlc": [_P] * 13 + [_I] * 9 + [_P],
    "gnuais_fir_probe": [_P] * 3 + [_I] * 3 + [_P],
    "gnuais_roofline_chain": [_P] * 4 + [_I] * 3 + [_P],
    "gnuais_roofline_stream": [_P] * 6 + [_I] * 4 + [_P],
}

# the strip variants' source and entry points, outside the main library
STRIP_SOURCE = "pipeline_strip.cu"
STRIP_ENTRIES = {
    "gnuais_pipeline_strip": [_P] * 13 + [_I] * 10 + [_P],
    "gnuais_pipeline_strip_mask": [],
}

_lib: Optional[ctypes.CDLL] = None
_strip_libs: dict = {}
_lock = threading.Lock()
build_log = ""   # compiler output of the library last built or found


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return (sorted(p for p in _CSRC.glob("*.cu") if p.name != STRIP_SOURCE),
            sorted(_CSRC.glob("*.cuh")))


def _digest(flags, paths) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (unless the library for these sources is
    cached) and return the library's path.  One ``nvcc -c`` per source,
    all started together, then one link.  The compiler's output, with
    each kernel's registers and spills (``-Xptxas -v``), is kept beside
    the library and in ``build_log``."""
    global build_log
    cu, cuh = _sources()
    # -Xptxas -v changes the compiler's report, not the library
    out_dir = BUILD_DIR / _digest(NVCC_FLAGS, cu + cuh)
    lib_path = out_dir / "libgnuais_tpu_torch.so"
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        if log_path.exists():
            build_log = log_path.read_text()
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    pid = os.getpid()
    objs = [out_dir / f".{p.stem}.{pid}.o" for p in cu]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p, o in zip(cu, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [p.name for p, proc in zip(cu, procs) if proc.returncode]
    if not failed:
        tmp = out_dir / f".lib.{pid}.so"
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    log_path.write_text(build_log)
    os.replace(tmp, lib_path)     # atomic: no reader sees a partial file
    return lib_path


def _load(path: Path, entries: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build(), _ENTRIES)
        return _lib


def _strip_target(mask: int):
    """(flags, library path) of the strip set ``mask``."""
    flags = [*NVCC_FLAGS, f"-DGNUAIS_STRIP={int(mask)}"]
    _, cuh = _sources()
    digest = _digest(flags, [_CSRC / STRIP_SOURCE, *cuh])
    return flags, BUILD_DIR / "strip" / digest / "libgnuais_strip.so"


def build_strips(masks) -> list:
    """Compile the strip libraries of ``masks`` (bit masks of the strip
    flags, ``fused.STRIP_FLAGS``) that are not cached, one ``nvcc`` each,
    all started together; returns their paths."""
    targets = [_strip_target(m) for m in masks]
    todo = [(f, p) for f, p in targets if not p.exists()]
    if todo:
        nvcc = nvcc_path()
        pid = os.getpid()
        for _, p in todo:
            p.parent.mkdir(parents=True, exist_ok=True)
        procs = [subprocess.Popen(
            [nvcc, *f, "-shared", "-o", str(p.with_suffix(f".{pid}.so")),
             str(_CSRC / STRIP_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f, p in todo]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed ({STRIP_SOURCE}):\n{failed[0]}")
        for _, p in todo:
            os.replace(p.with_suffix(f".{pid}.so"), p)
    return [p for _, p in targets]


def strip_library(mask: int) -> ctypes.CDLL:
    """The loaded library of kernel B2 with the strip set ``mask``, built
    on first use."""
    with _lock:
        if mask not in _strip_libs:
            lib = _load(build_strips([mask])[0], STRIP_ENTRIES)
            if lib.gnuais_pipeline_strip_mask() != mask:
                raise RuntimeError(f"strip library built for mask "
                                   f"{lib.gnuais_pipeline_strip_mask()}, "
                                   f"not {mask}")
            _strip_libs[mask] = lib
        return _strip_libs[mask]
