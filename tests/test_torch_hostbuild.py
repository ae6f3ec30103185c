"""Kernels B1 and B2 and the mxu probe as host C++ (``gnuais_tpu_torch.
hostbuild``): the kernel bodies of ``csrc/`` themselves (the FIR
producer warps, the ring's barriers and copies, the chain consumer
warp) run on the CPU, one std::thread per CUDA thread, through the
wrappers' ``_launch_*`` functions, against the plain versions: every
output and carry leaf bitwise, in every FIR mode and both input layouts
(time-major; row-major, with a pitch that does or does not allow
16-byte copies), at S = 1 and 37, T = 1000, over chained blocks.
Skips only where there is no ``g++``.
"""

import numpy as np
import pytest
import torch

from gnuais_tpu_torch import captures, hostbuild
from gnuais_tpu_torch.constants import FIR_LEN, FIR_TAPS
from gnuais_tpu_torch.ops import fir, fused
from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry

T = 1000


@pytest.fixture
def host(monkeypatch):
    if hostbuild.gxx_path() is None:
        pytest.skip("needs g++")
    hostbuild.library()
    monkeypatch.setattr(fused, "_launch", hostbuild.launch)


def _flat(out):
    flat = []
    for v in out:
        flat.extend(_flat(v) if isinstance(v, tuple) else [v])
    return flat


def _assert_same(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), i


def _rows(block: np.ndarray, layout: str):
    """The block as the kernel gets it: (rows [S, T], pretiled)."""
    if layout == "time":
        return torch.from_numpy(np.ascontiguousarray(block.T)).t(), True
    if layout == "row":
        return torch.from_numpy(np.ascontiguousarray(block)), False
    # row-major inside a wider array: an odd pitch and an offset start,
    # so that no 16-byte copy is allowed
    s, t = block.shape
    wide = np.zeros((s, t + 5), dtype=np.int16)
    wide[:, 3:3 + t] = block
    return torch.from_numpy(wide)[:, 3:3 + t], False


def _chain(x: np.ndarray, n_valid, layout: str, fir_mode: str,
           candidates: bool, base: int = 0):
    """Kernel and plain version over consecutive T-sample blocks of x,
    each chained through its own carry, n_valid per block."""
    s = x.shape[0]
    ck = cp = init_carry(s, "cpu")
    wrapper = fused.pipeline_fused if candidates \
        else fused.pipeline_fused_compact
    slots = fused.n_candidates(T) if candidates else 3
    for b, nv in enumerate(n_valid):
        block = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        rows, pretiled = _rows(block, layout)
        before = wrapper.launches
        k = fused._launch_pipeline(wrapper, rows, pretiled, nv, ck.history,
                                   ck.dpll, ck.hdlc, slots, base + b * T,
                                   fir_mode, None, None)
        assert wrapper.launches == before + 1
        kw = dict(block_base=base + b * T, fir_mode=fir_mode)
        xb = torch.from_numpy(block)
        p = (fused.pipeline_fused_reference(xb, nv, cp.history, cp.dpll,
                                            cp.hdlc, **kw) if candidates
             else fused.pipeline_fused_compact_reference(
                 xb, nv, cp.history, cp.dpll, cp.hdlc, frame_slots=slots,
                 **kw))
        _assert_same(k, p)
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])


@pytest.mark.parametrize("candidates", [False, True], ids=["b1", "b2"])
@pytest.mark.parametrize("fir_mode", ["vpu", "lobe", "mxu"])
@pytest.mark.parametrize("layout", ["time", "row", "row_unaligned"])
@pytest.mark.parametrize("s", [1, 37])
def test_kernel_body_matches_plain(host, s, layout, fir_mode, candidates):
    """Three chained blocks, n_valid T, 20 and 0 (a block that only
    freezes the carry)."""
    x = captures.mixed(s, 3 * T, seed=s + 7)
    _chain(x, (T, 20, 0), layout, fir_mode, candidates, base=77)


@pytest.mark.parametrize("fir_mode", ["vpu", "mxu"])
@pytest.mark.parametrize("nv", [1, 31, 32, 33, T - 333])
def test_kernel_body_chunk_edges(host, nv, fir_mode):
    """n_valid on and off the 32-sample chunk grid (the ring's chunk
    count, a partial last chunk), B2 on row-major input with 16-byte
    copies (S = 64), then a full block on the carry."""
    x = captures.noisy_frames(64, 2 * T, seed=nv)
    _chain(x, (nv, T), "row", fir_mode, True)


@pytest.mark.parametrize("s,t", [(37, 1000), (1, 4096)])
def test_probe_body_within_bound(host, s, t):
    """The mxu producer stage alone (fir_probe.cu) within MXU_BOUND of
    the exact FIR, from a history of noise."""
    x = torch.from_numpy(captures.mixed(s, t, seed=s))
    h = torch.from_numpy(captures.garbage(s, FIR_LEN, seed=t)
                         .astype(np.float32))
    k = fused._launch_probe(x, h).double()
    e = fir.fir_exact(x, h)[0].double()
    full = torch.cat([h, x.float()], dim=1).double()
    mag = sum((full[:, i:i + t] * float(c)).abs()
              for i, c in enumerate(np.asarray(FIR_TAPS, np.float32)))
    lim = fused.MXU_BOUND[0] * mag + fused.MXU_BOUND[1]
    assert ((k - e).abs() <= lim).all()
