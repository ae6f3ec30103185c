"""The port's CUDA kernels built as host C++, to run their logic on the CPU.

The kernel sources of ``gnuais_tpu_torch/csrc`` compile with ``g++
-std=c++20 -ffp-contract=off -pthread`` against the stand-in headers of
``include/`` (``cuda_runtime.h``: each launch's blocks one after another,
one std::thread per CUDA thread, barriers and mbarriers on the host;
``mma.h``: whole-tile WMMA fragments), with ``GNUAIS_HOST_BUILD``
defined, into one library under ``build/hostbuild/`` at the repository
root (git-ignored), cached by a hash of the sources.  Each
``kernel<<<grid, block, smem, stream>>>(args)`` launch is rewritten on
the way into a call of the stand-in's ``launch``.

The wrappers' ``_launch_*`` functions then run on CPU tensors against
the plain versions, with ``launch`` in place of ``ops.fused._launch``::

    from gnuais_tpu_torch import hostbuild
    from gnuais_tpu_torch.ops import fused
    fused._launch = hostbuild.launch      # e.g. with pytest's monkeypatch

It runs the kernels' control flow (the producer and consumer warps,
the ring's barriers, the copies and the edges), not their speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE.parent / "csrc"
BUILD_DIR = _HERE.parents[1] / "build" / "hostbuild"
# the kernel sources the host build covers
SOURCES = ("pipeline_compact.cu", "pipeline_fused.cu", "fir_probe.cu",
           "frontend.cu", "dpll.cu", "hdlc.cu")
GXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-fPIC",
             "-shared", "-DGNUAIS_HOST_BUILD"]

# kernel<<<config>>>(args);  ->  gnuais_host::launch([&] { kernel(args); }, config);
_LAUNCH = re.compile(
    r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def gxx_path() -> Optional[str]:
    """The host compiler, or None where there is none."""
    return shutil.which("g++")


def _rewrite(text: str) -> str:
    return _LAUNCH.sub(
        lambda m: f"gnuais_host::launch([&] {{ {m[1]}({m[3]}); }}, {m[2]});",
        text)


def build() -> Path:
    """Compile the host library (unless cached) and return its path."""
    gxx = gxx_path()
    if gxx is None:
        raise RuntimeError("g++ not found")
    files = sorted(_CSRC.glob("*.cu*")) + sorted((_HERE / "include").glob("*.h"))
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / "libgnuais_host.so"
    if lib_path.exists():
        return lib_path
    src = out_dir / f"src.{os.getpid()}"    # one per process building
    src.mkdir(parents=True, exist_ok=True)
    for p in sorted(_CSRC.glob("*.cu*")):
        (src / p.name).write_text(_rewrite(p.read_text()))
    tmp = out_dir / f".lib.{os.getpid()}.so"
    res = subprocess.run(
        [gxx, *GXX_FLAGS, "-I", str(_HERE / "include"), "-I", str(src),
         "-x", "c++", *(str(src / s) for s in SOURCES), "-o", str(tmp)],
        capture_output=True, text=True)
    shutil.rmtree(src, ignore_errors=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    from ..ops import _build
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("gnuais_pipeline_compact", "gnuais_pipeline_fused",
                         "gnuais_fir_probe", "gnuais_frontend", "gnuais_dpll",
                         "gnuais_hdlc"):
                fn = getattr(lib, name)
                fn.argtypes = _build._ENTRIES[name]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(entry: str, *args) -> None:
    """``ops.fused._launch`` for CPU tensors: call the host library's
    ``entry`` with ``args`` (tensors as pointers) and no stream."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            raise ValueError(f"host build takes CPU tensors, got {a.device}")
    err = getattr(library(), entry)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        None)
    if err:
        raise RuntimeError(f"{entry} failed: error {err}")
