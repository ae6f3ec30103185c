"""The PyTorch port's package boundary: it imports neither JAX nor the
JAX package, it never answers a request for the card with the CPU, and
its CUDA sources carry the exact constants of the JAX package."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnuais_tpu import constants as C

REPO = Path(__file__).resolve().parent.parent
MODULES = [
    "gnuais_tpu_torch",
    "gnuais_tpu_torch.device",
    "gnuais_tpu_torch.captures",
    "gnuais_tpu_torch.convert",
    "gnuais_tpu_torch.cli",
    "gnuais_tpu_torch.profile_kernels",
    "gnuais_tpu_torch.roofline",
    "gnuais_tpu_torch.card",
    "gnuais_tpu_torch.ops.fir",
    "gnuais_tpu_torch.ops.demod",
    "gnuais_tpu_torch.ops.crc",
    "gnuais_tpu_torch.ops.fused",
    "gnuais_tpu_torch.ops._build",
    "gnuais_tpu_torch.runtime.pipeline",
    "gnuais_tpu_torch.runtime.batch",
    "gnuais_tpu_torch.runtime.streaming",
    "gnuais_tpu_torch.runtime.checkpoint",
    "gnuais_tpu_torch.runtime.supervisor",
    "gnuais_tpu_torch.ops.discriminator",
    "gnuais_tpu_torch.io.iq",
    "gnuais_tpu_torch.parallel",
    "gnuais_tpu_torch.parallel.mesh",
    "gnuais_tpu_torch.parallel.sharded",
    "gnuais_tpu_torch.parallel.timepar",
    # the port's own copies of the JAX package's host modules
    "gnuais_tpu_torch.constants",
    "gnuais_tpu_torch.config",
    "gnuais_tpu_torch.ais",
    "gnuais_tpu_torch.ais.bits",
    "gnuais_tpu_torch.ais.nmea",
    "gnuais_tpu_torch.ais.parser",
    "gnuais_tpu_torch.ais.dispatcher",
    "gnuais_tpu_torch.golden",
    "gnuais_tpu_torch.golden.model",
    "gnuais_tpu_torch.golden.encoder",
    "gnuais_tpu_torch.native",
    "gnuais_tpu_torch.io",
    "gnuais_tpu_torch.io.audio",
    "gnuais_tpu_torch.io.sinks",
    "gnuais_tpu_torch.runtime.metrics",
    "gnuais_tpu_torch.runtime.session",
    "gnuais_tpu_torch.io.live",
    "gnuais_tpu_torch.io.alsa",
    "gnuais_tpu_torch.io.pulse",
    "gnuais_tpu_torch.io.db",
    "gnuais_tpu_torch.io.mysql",
    "gnuais_tpu_torch.io.cache",
    "gnuais_tpu_torch.monitor",
    "gnuais_tpu_torch.monitor.ships",
    "gnuais_tpu_torch.monitor.webmap",
]


def test_port_imports_without_jax():
    """Every module imports in a fresh interpreter where ``import jax``
    and ``import gnuais_tpu`` fail (tests/conftest.py imports both in
    this process)."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['gnuais_tpu'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gnuais_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'gnuais_tpu.')))\n"
            "bad = [m for m in bad if sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_modules(path: Path):
    """(line, module) of every import statement in a Python file; a
    relative import counts as its resolved ``gnuais_tpu_torch`` name."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield node.lineno, "gnuais_tpu_torch"
            else:
                yield node.lineno, node.module


def test_no_source_imports_the_jax_package():
    """An ast scan of every .py file of the port and of chip_smoke.py:
    no import of ``gnuais_tpu`` (or a module of it) or of ``jax``."""
    files = sorted((REPO / "gnuais_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    bad = [f"{p.relative_to(REPO)}:{line} {mod}"
           for p in files for line, mod in _imported_modules(p)
           if mod.split(".")[0] in ("gnuais_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_resolve_device_never_falls_back():
    from gnuais_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_receiver_defaults_to_cuda():
    from gnuais_tpu_torch.runtime.pipeline import TorchReceiver
    if torch.cuda.is_available():
        assert TorchReceiver("A").pipe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TorchReceiver("A")


def test_kernel_taps_are_the_float32_taps():
    """The hex float literals of the CUDA header are the JAX package's
    float32 taps, bit for bit (taps 2 and 33 are subnormal)."""
    src = (REPO / "gnuais_tpu_torch" / "csrc" / "pipeline_step.cuh").read_text()
    body = src.split("#define GNUAIS_FIR_TAPS", 1)[1].split("\n\n", 1)[0]
    lits = re.findall(r"(0x[0-9a-f.]+p[+-]?\d+)f", body)
    taps = np.array([float.fromhex(v) for v in lits], dtype=np.float32)
    assert len(taps) == C.FIR_LEN
    assert np.array_equal(taps.view(np.uint32),
                          np.asarray(C.FIR_TAPS, np.float32).view(np.uint32))
    assert np.count_nonzero((taps != 0) & (np.abs(taps) < np.finfo(np.float32).tiny)) == 2


def test_kernel_build_flags_keep_rounding_exact():
    """No multiply-add contraction and no fast math (flush-to-zero),
    Hopper's sm_90a target; the build lands under build/ (gitignored)."""
    from gnuais_tpu_torch.ops import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_throughput_entry_points_default_to_cuda(tmp_path):
    """The lanes, the mesh session and the IQ readers want the card
    unless the CPU is asked for; where there is none they raise."""
    from gnuais_tpu_torch.io.iq import IqStreamReader
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import time_parallel_decode
    iq = tmp_path / "x.iq"
    iq.write_bytes(bytes(8 * 64))
    calls = [lambda: time_parallel_decode(np.zeros(5000, np.int16)),
             lambda: make_grid_mesh(1, 1),
             lambda: IqStreamReader(iq)]
    if torch.cuda.is_available():
        assert make_grid_mesh(1, 1).device.type == "cuda"
        assert IqStreamReader(iq).device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
