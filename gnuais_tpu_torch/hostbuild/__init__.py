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
the ring's barriers, the copies and the edges), not their speed.  The
strip variants of kernel B2 (``csrc/pipeline_strip.cu``) build the same
way, one library for each strip set (``build_strips``); ``launch`` takes
the set as its ``strip`` argument, as ``ops.fused._launch`` does.
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
_strip_libs: dict = {}
_lock = threading.Lock()


def gxx_path() -> Optional[str]:
    """The host compiler, or None where there is none."""
    return shutil.which("g++")


def _rewrite(text: str) -> str:
    return _LAUNCH.sub(
        lambda m: f"gnuais_host::launch([&] {{ {m[1]}({m[3]}); }}, {m[2]});",
        text)


def _build_many(jobs) -> list:
    """Compile each (extra flags, sources, library name) of ``jobs``
    unless cached, one g++ each, all started together; returns the
    libraries' paths."""
    gxx = gxx_path()
    if gxx is None:
        raise RuntimeError("g++ not found")
    files = sorted(_CSRC.glob("*.cu*")) + sorted((_HERE / "include").glob("*.h"))
    targets = []
    for flags, sources, name in jobs:
        h = hashlib.sha256(" ".join(GXX_FLAGS + flags + sources).encode())
        for p in files:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        targets.append((flags, sources, BUILD_DIR / h.hexdigest()[:16] / name))
    todo = [t for t in targets if not t[2].exists()]
    if todo:
        # the rewritten sources, one copy per process building
        src = BUILD_DIR / f"src.{os.getpid()}"
        src.mkdir(parents=True, exist_ok=True)
        for p in sorted(_CSRC.glob("*.cu*")):
            (src / p.name).write_text(_rewrite(p.read_text()))
        procs = []
        for flags, sources, lib_path in todo:
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.parent / f".{lib_path.stem}.{os.getpid()}.so"
            procs.append((subprocess.Popen(
                [gxx, *GXX_FLAGS, *flags, "-I", str(_HERE / "include"),
                 "-I", str(src), "-x", "c++", *(str(src / s) for s in sources),
                 "-o", str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib_path))
        errors = []
        for proc, tmp, lib_path in procs:
            out = proc.communicate()[0]
            if proc.returncode:
                errors.append(out)
            else:
                os.replace(tmp, lib_path)
        shutil.rmtree(src, ignore_errors=True)
        if errors:
            raise RuntimeError(f"g++ failed:\n{errors[0]}")
    return [t[2] for t in targets]


def build() -> Path:
    """Compile the host library (unless cached) and return its path."""
    return _build_many([([], list(SOURCES), "libgnuais_host.so")])[0]


def build_strips(masks) -> list:
    """Compile the host libraries of kernel B2's strip sets ``masks``
    (``ops.fused.STRIP_FLAGS`` bits) that are not cached, all at once;
    returns their paths."""
    from ..ops import _build
    return _build_many([([f"-DGNUAIS_STRIP={int(m)}"], [_build.STRIP_SOURCE],
                         "libgnuais_strip.so") for m in masks])


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    from ..ops import _build
    with _lock:
        if _lib is None:
            _lib = _build._load(build(), {
                name: _build._ENTRIES[name] for name in (
                    "gnuais_pipeline_compact", "gnuais_pipeline_fused",
                    "gnuais_fir_probe", "gnuais_frontend", "gnuais_dpll",
                    "gnuais_hdlc")})
        return _lib


def strip_library(mask: int) -> ctypes.CDLL:
    """The loaded host library of the strip set ``mask``, built on first
    use."""
    from ..ops import _build
    with _lock:
        if mask not in _strip_libs:
            _strip_libs[mask] = _build._load(build_strips([mask])[0],
                                             _build.STRIP_ENTRIES)
        return _strip_libs[mask]


def launch(entry: str, *args, strip: int = 0) -> None:
    """``ops.fused._launch`` for CPU tensors: call the host library's
    ``entry`` (the strip set ``strip``'s when it is not 0) with ``args``
    (tensors as pointers) and no stream."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            raise ValueError(f"host build takes CPU tensors, got {a.device}")
    lib = strip_library(strip) if strip else library()
    err = getattr(lib, entry)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        None)
    if err:
        raise RuntimeError(f"{entry} failed: error {err}")
