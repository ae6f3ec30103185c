"""The fused CUDA kernel against its plain PyTorch version on the card,
bitwise.  Needs an NVIDIA GPU with nvcc (sm_90a): every test here is
marked ``cuda`` and skips without a device.  Imports no JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnuais_tpu_torch import captures
from gnuais_tpu_torch.ops import crc, fused
from gnuais_tpu_torch.runtime.pipeline import (BatchPipeline, PipelineCarry,
                                               decode_block, init_carry)

pytestmark = pytest.mark.cuda
T = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flat(out):
    flat = []
    for v in out:
        flat.extend(_flat(v) if isinstance(v, tuple) else [v])
    return flat


def _assert_same(a, b):
    for i, (x, y) in enumerate(zip(_flat(a), _flat(b))):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), i


def _pair(x, nv, carry, **kw):
    args = (x, nv, carry.history, carry.dpll, carry.hdlc)
    before = fused.pipeline_fused_compact.launches
    k = fused.pipeline_fused_compact(*args, **kw)
    assert fused.pipeline_fused_compact.launches == before + 1
    p = fused.pipeline_fused_compact_reference(*args, **kw)
    torch.cuda.synchronize()
    return k, p


CASES = {
    "frames_S1": (captures.noisy_frames, 1, T, 8, 0, None),
    "mixed_tail_S37": (captures.mixed, 37, T - 333, 8, 77, None),
    "short_tail_S37": (captures.mixed, 37, 20, 8, 0, None),
    "lost2_window_S256": (captures.mixed, 256, T, 8, 1000,
                          (1000 + 2600, 1000 + 3600)),
    "overflow_S256": (captures.minimal_frames, 256, T, 3, 0, None),
    "rejects_S129": (captures.wrong_size_and_crc, 129, T, 24, 2**31 - 1000,
                     None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    build, s, nv, fs, base, window = CASES[case]
    x = torch.from_numpy(build(s, T, seed=len(case))).to(cuda)
    lo, hi = window or (None, None)
    k, p = _pair(x, nv, init_carry(s, cuda), frame_slots=fs, block_base=base,
                 lost2_lo=lo, lost2_hi=hi)
    _assert_same(k, p)


def test_kernel_rejects_mismatched_state(cuda):
    """The wrapper checks every state leaf before passing pointers: a
    carry for fewer streams, or one left on the CPU, raises and launches
    nothing."""
    x = torch.zeros((8, 1024), dtype=torch.int16, device=cuda)
    before = fused.pipeline_fused_compact.launches
    for c in (init_carry(4, cuda), init_carry(8, "cpu")):
        with pytest.raises(ValueError):
            fused.pipeline_fused_compact(x, 1024, c.history, c.dpll, c.hdlc)
    assert fused.pipeline_fused_compact.launches == before


def test_kernel_chained_blocks(cuda):
    s = 37
    x = captures.mixed(s, 3 * T, seed=8)
    ck = cp = init_carry(s, cuda)
    for b in range(3):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * T:(b + 1) * T])).to(cuda)
        nv = T if b < 2 else T - 333
        kw = dict(frame_slots=8, block_base=b * T)
        k = fused.pipeline_fused_compact(xb, nv, ck.history, ck.dpll, ck.hdlc, **kw)
        p = fused.pipeline_fused_compact_reference(xb, nv, cp.history, cp.dpll,
                                                   cp.hdlc, **kw)
        _assert_same(k, p)
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])


def test_crc_check_exact_under_tf32(cuda):
    """The linear CRC product is exact with TF32 on (0/1 operands, sums
    at most 480), and the check leaves the global flag as it found it."""
    s, fs = 64, 16
    c = init_carry(s, "cpu")
    out = fused.pipeline_fused_compact_reference(
        torch.from_numpy(captures.mixed(s, T, seed=4)), T, c.history, c.dpll,
        c.hdlc, frame_slots=fs)
    present = torch.arange(fs)[None, :] < out[0].clamp(max=fs)[:, None]
    rng = np.random.default_rng(4)
    words = torch.cat([out[1][present], torch.from_numpy(
        rng.integers(0, 2**32, (1024, 15), dtype=np.uint32).view(np.int32))])
    length = torch.cat([out[2][present], torch.from_numpy(
        rng.integers(-4, 460, 1024).astype(np.int32))])
    want = crc.crc_check_frames_linear(words, length)
    assert want.sum() > 0
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = crc.crc_check_frames_linear(words.to(cuda), length.to(cuda))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(got.cpu(), want)


def test_fused_decode_block_on_card_matches_cpu(cuda):
    """The whole fused branch with the device CRC filter: the card's
    FrameBatch and carry equal the CPU run's."""
    s = 64
    x = captures.mixed(s, T, seed=11)
    out = []
    for dev in (cuda, torch.device("cpu")):
        c, f, p = decode_block(torch.from_numpy(x).to(dev), T,
                               init_carry(s, dev), frame_slots=16,
                               fused_pipeline=True, device_crc=True)
        out.append([t.cpu() for t in _flat((c, f, p))])
    _assert_same(out[0], out[1])


def test_batch_pipeline_on_card(cuda):
    x = captures.noisy_frames(8, T, seed=2)
    res = []
    for dev in (cuda, "cpu"):
        pipe = BatchPipeline(8, block_len=T, frame_slots=8, fused_pipeline=True,
                             device_crc=True, device=dev)
        frames = pipe.process(x)
        res.append(([[f.payload_bits.tobytes() for f in fr] for fr in frames],
                    [vars(c) for c in pipe.counters]))
    assert res[0] == res[1]
    assert sum(len(f) for f in res[0][0]) > 0
