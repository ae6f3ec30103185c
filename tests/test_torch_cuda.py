"""The CUDA kernels (B1 ``pipeline_fused_compact`` and B2
``pipeline_fused``, each with the exact, the lobe and the mxu FIR; B2's
prefiltered mode, and its strip variants held by their invariants;
B1's and B2's landing on the densest completions), B3
``frontend_fused``, B4 ``dpll_fused``, the mxu probe and the roofline
kernels R1 and R2) against their plain PyTorch versions on the card,
bitwise (the mxu FIR's values within ``fused.MXU_BOUND``), and the paths
through them (pretiled input included) against the CPU; ``fir_conv``
with TF32 off.  Needs an
NVIDIA GPU with nvcc (sm_90a): every test here is
marked ``cuda`` and skips without a device.  Imports no JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnuais_tpu_torch import captures
from gnuais_tpu_torch import roofline as R
from gnuais_tpu_torch.constants import FIR_LEN, FIR_TAPS
from gnuais_tpu_torch.ops import crc, fir, fused
from gnuais_tpu_torch.runtime.pipeline import (BatchPipeline, PipelineCarry,
                                               decode_block, init_carry)
from gnuais_tpu_torch.runtime.streaming import PipelinedDecoder

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


@pytest.mark.parametrize("fir_mode", ["vpu", "lobe"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_kernel_matches_plain(cuda, case, fir_mode):
    """Kernel B2 against its plain version, every leaf (the empty
    candidate slots included: both zero them), and B1 with the same FIR
    against its plain version and against B2's candidates compacted."""
    build, s, nv, fs, base, window = CASES[case]
    x = torch.from_numpy(build(s, T, seed=len(case))).to(cuda)
    lo, hi = window or (None, None)
    c = init_carry(s, cuda)
    kw = dict(block_base=base, fir_mode=fir_mode, lost2_lo=lo, lost2_hi=hi)
    args = (x, nv, c.history, c.dpll, c.hdlc)
    before = fused.pipeline_fused.launches
    k2 = fused.pipeline_fused(*args, **kw)
    assert fused.pipeline_fused.launches == before + 1
    k1, p1 = _pair(x, nv, c, frame_slots=fs, **kw)
    p2 = fused.pipeline_fused_reference(*args, **kw)
    assert k2[0].shape == (s, fused.n_candidates(T))
    _assert_same(k2, p2)
    _assert_same(k1, p1)
    _assert_same(fused.compact_slots(k2, fs), k1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mxu_kernels_match_plain(cuda, case):
    """B2 and B1 with the mxu FIR (tensor cores, 3xTF32) against their
    plain versions (cuBLAS float32 with TF32 off) at ragged S: every
    output and carry leaf.  The sums differ in order only, far below
    any slicer decision of these captures, so the frames and carry are
    the same; and B1 mxu against B1 with the exact FIR: the same frames
    on every row that is not garbage (``captures.mixed`` makes every
    fourth row noise alone)."""
    build, s, nv, fs, base, window = CASES[case]
    x = torch.from_numpy(build(s, T, seed=len(case))).to(cuda)
    lo, hi = window or (None, None)
    c = init_carry(s, cuda)
    kw = dict(block_base=base, fir_mode="mxu", lost2_lo=lo, lost2_hi=hi)
    args = (x, nv, c.history, c.dpll, c.hdlc)
    before = (fused.pipeline_fused.launches,
              fused.pipeline_fused_compact.launches)
    k2 = fused.pipeline_fused(*args, **kw)
    k1 = fused.pipeline_fused_compact(*args, frame_slots=fs, **kw)
    assert (fused.pipeline_fused.launches,
            fused.pipeline_fused_compact.launches) == tuple(
                n + 1 for n in before)
    p2 = fused.pipeline_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_same(k2, p2)
    _assert_same(k1, fused.compact_slots(p2, fs))
    kv = fused.pipeline_fused_compact(*args, frame_slots=fs,
                                      **dict(kw, fir_mode="vpu"))
    rows = torch.arange(s, device=cuda)
    rows = rows[rows % 4 != 1] if build is captures.mixed else rows
    _assert_same([v[rows] for v in k1[:5]], [v[rows] for v in kv[:5]])


# (S, T, n_valid of three chained blocks): ragged and single streams,
# T on and off the 32-sample chunk grid, n_valid around the chunk edges
RING_EDGES = {
    "S1_T1000": (1, 1000, (1000, 0, 1)),
    "S31_T1024": (31, 1024, (20, 31, 1024)),
    "S33_T8192": (33, 8192, (32, 8192, 8192 - 333)),
    "S37_T1000": (37, 1000, (33, 1, 1000 - 333)),
    "S4096_T1024": (4096, 1024, (1024, 31, 1024 - 333)),
}


@pytest.mark.parametrize("pretiled", [False, True], ids=["row", "time"])
@pytest.mark.parametrize("fir_mode", ["vpu", "lobe", "mxu"])
@pytest.mark.parametrize("case", sorted(RING_EDGES))
def test_ring_edges_match_plain(cuda, case, fir_mode, pretiled):
    """B2 and B1 (the producer and consumer warps around the ring) over
    three chained blocks against their plain versions, every output and
    carry leaf bitwise, each side on its own carry; the input row-major
    or time-major (pretiled_streams)."""
    s, t, nvs = RING_EDGES[case]
    x = captures.mixed(s, 3 * t, seed=s + t)
    ck = cp = init_carry(s, cuda)
    for b, nv in enumerate(nvs):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * t:(b + 1) * t])).to(cuda)
        kw = dict(block_base=b * t + 5, fir_mode=fir_mode)
        xin = xb.t().contiguous() if pretiled else xb
        tiled = dict(pretiled_streams=s) if pretiled else {}
        before = (fused.pipeline_fused.launches,
                  fused.pipeline_fused_compact.launches)
        k2 = fused.pipeline_fused(xin, nv, ck.history, ck.dpll, ck.hdlc,
                                  **kw, **tiled)
        k1 = fused.pipeline_fused_compact(xin, nv, ck.history, ck.dpll,
                                          ck.hdlc, frame_slots=5, **kw,
                                          **tiled)
        assert (fused.pipeline_fused.launches,
                fused.pipeline_fused_compact.launches) == tuple(
                    n + 1 for n in before)
        p2 = fused.pipeline_fused_reference(xb, nv, cp.history, cp.dpll,
                                            cp.hdlc, **kw)
        torch.cuda.synchronize()
        _assert_same(k2, p2)
        _assert_same(k1, fused.compact_slots(p2, 5))
        ck, cp = PipelineCarry(*k2[7:]), PipelineCarry(*p2[7:])


def test_row_major_view_is_read_in_place(cuda):
    """A row-major block that is a view of a wider array (an odd pitch,
    no 16-byte copies) gives the same as its contiguous copy."""
    s, t = 37, 1024
    wide = torch.from_numpy(captures.mixed(s, t + 7, seed=5)).to(cuda)
    view = wide[:, 3:3 + t]
    c = init_carry(s, cuda)
    for mode in fused.FIR_MODES:
        a = fused.pipeline_fused(view, t, c.history, c.dpll, c.hdlc,
                                 fir_mode=mode)
        b = fused.pipeline_fused(view.contiguous(), t, c.history, c.dpll,
                                 c.hdlc, fir_mode=mode)
        _assert_same(a, b)


def test_mxu_chained_blocks_and_short_tail(cuda):
    """B1 mxu over three chained blocks of T = 1000 (the last chunk of
    32 padded), the last one 20 samples, each side on its own carry."""
    s, t = 37, 1000
    x = captures.mixed(s, 3 * t, seed=18)
    ck = cp = init_carry(s, cuda)
    for b, nv in enumerate((t, t, 20)):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * t:(b + 1) * t])).to(cuda)
        kw = dict(frame_slots=3, block_base=b * t, fir_mode="mxu")
        k = fused.pipeline_fused_compact(xb, nv, ck.history, ck.dpll, ck.hdlc, **kw)
        p = fused.pipeline_fused_compact_reference(xb, nv, cp.history, cp.dpll,
                                                   cp.hdlc, **kw)
        _assert_same(k, p)
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])


@pytest.mark.parametrize("s,t", [(1, 4096), (37, 1000), (256, 4096)])
def test_mxu_probe_matches_plain(cuda, s, t):
    """The tensor-core FIR alone: within MXU_BOUND of fir_exact and of
    the plain fir_mxu, from a history of noise."""
    x = captures.mixed(s, t, seed=s)
    h = captures.garbage(s, FIR_LEN, seed=t).astype(np.float32)
    xt, ht = torch.from_numpy(x).to(cuda), torch.from_numpy(h).to(cuda)
    before = fused.fir_mxu_probe.launches
    k = fused.fir_mxu_probe(xt, ht).cpu().double()
    assert fused.fir_mxu_probe.launches == before + 1
    p = fir.fir_mxu(xt, ht)[0].cpu().double()
    e = fir.fir_exact(xt, ht)[0].cpu().double()
    full = np.concatenate([h, x.astype(np.float32)], axis=1).astype(np.float64)
    taps = np.asarray(FIR_TAPS, np.float32).astype(np.float64)
    mag = torch.from_numpy(sum(np.abs(full[:, i:i + t] * taps[i])
                               for i in range(FIR_LEN)))
    lim = fused.MXU_BOUND[0] * mag + fused.MXU_BOUND[1]
    assert ((k - e).abs() <= lim).all()
    assert ((k - p).abs() <= 2 * lim).all()


@pytest.mark.parametrize("mode", R.CHAIN_MODES)
def test_roofline_chain_matches_plain(cuda, mode):
    seed = torch.from_numpy(np.random.default_rng(3).integers(
        1, 2**31 - 1, 100, dtype=np.int32))
    before = R.chain.launches
    k = R.chain(seed.to(cuda), 2048, mode)
    assert R.chain.launches == before + 1
    p = R.chain(seed, 2048, mode)
    _assert_same([t.cpu() for t in _flat(k)], _flat(p))


@pytest.mark.parametrize("mode", R.STREAM_MODES)
def test_roofline_stream_matches_plain(cuda, mode):
    x = torch.from_numpy(captures.mixed(100, 2048, seed=4).T.copy())
    dummy = torch.arange(R.N_DUMMY * 100, dtype=torch.int32).reshape(-1, 100)
    before = R.stream.launches
    k = R.stream(x.to(cuda), mode, 2, dummy.to(cuda))
    assert R.stream.launches == before + 1
    p = R.stream(x, mode, 2, dummy)
    _assert_same([t.cpu() for t in _flat(k) if t is not None],
                 [t for t in _flat(p) if t is not None])


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


@pytest.mark.parametrize("lobe", [False, True], ids=["vpu", "lobe"])
@pytest.mark.parametrize("compact", [False, True], ids=["b2", "b1"])
def test_fused_decode_block_on_card_matches_cpu(cuda, compact, lobe):
    """The whole fused branch (B2 and compaction, or B1) with the device
    CRC filter: the card's FrameBatch and carry equal the CPU run's."""
    s = 64
    x = captures.mixed(s, T, seed=11)
    out = []
    for dev in (cuda, torch.device("cpu")):
        c, f, p = decode_block(torch.from_numpy(x).to(dev), T,
                               init_carry(s, dev), frame_slots=16,
                               fused_pipeline=True, device_crc=True,
                               kernel_compact=compact, lobe_fir=lobe)
        out.append([t.cpu() for t in _flat((c, f, p))])
    _assert_same(out[0], out[1])


@pytest.mark.parametrize("compact", [False, True], ids=["b2", "b1"])
def test_pretiled_on_card_matches_row_major(cuda, compact):
    """decode_block on a time-major block (tile_superblock) equals the
    row-major call on the card and the CPU's pretiled call: FrameBatch
    and carry, over two chained blocks, a full one (assume_full) and a
    short one."""
    s = 64
    x = torch.from_numpy(captures.mixed(s, 2 * T, seed=14))
    kw = dict(frame_slots=16, fused_pipeline=True, kernel_compact=compact,
              device_crc=True, with_peak=False)
    out = []
    for dev, pretiled in ((cuda, False), (cuda, True), ("cpu", True)):
        c, leaves = init_carry(s, dev), []
        tiles = fused.tile_superblock(x.to(dev), 2)
        for b, nv in enumerate((T, T - 333)):
            xb = tiles[b] if pretiled else x[:, b * T:(b + 1) * T].to(dev)
            c, f, _ = decode_block(xb, nv, c, block_base=b * T,
                                   pretiled_streams=s if pretiled else None,
                                   assume_full=nv == T, **kw)
            leaves += [t.cpu() for t in _flat((c, f))]
        out.append(leaves)
    _assert_same(out[0], out[1])
    _assert_same(out[1], out[2])


def test_fir_conv_on_card_keeps_tf32_off(cuda):
    """fir_conv on the card with the global cuDNN TF32 flag on: within
    float32 reassociation (2 * 36 * 2^-24 of the products' magnitudes)
    of a float64 sum, which TF32's 10-bit mantissa would exceed, and the
    flag is as it was afterwards."""
    s = 16
    x = captures.noisy_frames(s, T, seed=15)
    h = captures.garbage(s, FIR_LEN, seed=16).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        out, hist = fir.fir_conv(torch.from_numpy(x).to(cuda),
                                 torch.from_numpy(h).to(cuda))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    full = np.concatenate([h, x.astype(np.float32)], axis=1).astype(np.float64)
    taps = np.asarray(FIR_TAPS, np.float32).astype(np.float64)
    want = sum(full[:, i:i + T] * taps[i] for i in range(FIR_LEN))
    mag = sum(np.abs(full[:, i:i + T] * taps[i]) for i in range(FIR_LEN))
    assert np.all(np.abs(out.cpu().numpy() - want) <= 2 * 36 * 2**-24 * mag)
    assert torch.equal(hist.cpu(), torch.from_numpy(x[:, -FIR_LEN:]).float())


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


def test_batch_session_pinned_staging_on_card(cuda):
    """The batch session on the card stages its blocks in page-locked
    memory and uploads every block from it (the profiler's host-to-device
    copy is labelled pinned, and each block is counted), and decodes two
    calls, full streams then unequal ones, as on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from gnuais_tpu_torch.runtime import trace
    from gnuais_tpu_torch.runtime.batch import BatchSession
    x = captures.mixed(8, 3 * T, seed=16)
    calls = [[x[i, :T] for i in range(8)],
             [x[i, T:T + (2 * T, T - 1000, 0, 700)[i % 4]]
              for i in range(8)]]
    names = [f"s{i}" for i in range(8)]
    res = []
    for dev in (cuda, "cpu"):
        sess = BatchSession(names, block_len=T, frame_slots=16,
                            backend="fused", device=dev)
        assert torch.from_numpy(sess.staging).is_pinned() == (dev == cuda)
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = [sess.run(streams) for streams in calls]
        counters = trace.counters()
        trace.reset()
        res.append([(r.lines, r.counters, r.samples) for r in got])
        if dev == cuda:
            # calls of 1 and 2 full blocks
            assert counters["batch.blocks"] == 3
            assert counters["batch.staged_pinned"] == 3
            copies = [e.key for e in prof.key_averages()
                      if "HtoD" in e.key]
            assert any("Pinned" in k for k in copies), copies
        else:
            assert "batch.staged_pinned" not in counters
    assert res[0] == res[1]
    assert sum(len(lines) for lines, _, _ in res[0]) > 0


def test_batch_session_iq_on_card_is_the_plain_reference(cuda):
    """The batch session's IQ input at 64 streams on the card: each block's
    rails staged in the pinned buffer and uploaded from it (the rails'
    bytes counted once), the front end's audio within the plain reference
    front end's limits (``portbench/reference/iq.py``: none off by more
    than 1 LSB, at most one in 1000 by 1), and its decode that of the
    int16 session on the same audio."""
    from torch.profiler import ProfilerActivity, profile

    from gnuais_tpu_torch.runtime import trace
    from gnuais_tpu_torch.runtime.batch import BatchSession
    from portbench.reference import iq as ref_iq
    s, decim = 64, 4
    audio = captures.mixed(s, 2 * T, seed=18)
    f = np.repeat(audio.astype(np.float64) / 8000 * 2400, decim, axis=1)
    phase = 2 * np.pi * np.cumsum(f, axis=1) / (48_000 * decim)
    iq = np.stack([np.cos(phase), np.sin(phase)]).astype(np.float32)
    names = [f"s{i}" for i in range(s)]
    sess = BatchSession(names, block_len=T, frame_slots=16, backend="fused",
                        device=cuda, iq=True, decim=decim)
    assert sess.staging.shape == (2, s, T * decim)
    assert torch.from_numpy(sess.staging).is_pinned()
    seen, process = [], sess.pipe.process

    def rec(block):
        seen.append(block.clone())
        return process(block)
    sess.pipe.process = rec
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = sess.run([(iq[0, i], iq[1, i]) for i in range(s)])
    counters = trace.counters()
    trace.reset()
    assert counters["iq.h2d_bytes"] == iq.nbytes
    assert counters["batch.staged_pinned"] == counters["batch.blocks"] == 2
    got = torch.cat(seen, dim=1)
    assert got.is_cuda and got.dtype == torch.int16
    want, _ = ref_iq.frontend(torch.from_numpy(iq[0]).to(cuda),
                              torch.from_numpy(iq[1]).to(cuda),
                              ref_iq.start(s, cuda), decim)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int((diff > 1).sum()) == 0
    assert int((diff == 1).sum()) <= diff.numel() // 1000
    host = got.cpu().numpy()
    plain = BatchSession(names, block_len=T, frame_slots=16,
                         backend="fused", device=cuda).run(list(host))
    assert res.lines == plain.lines and res.counters == plain.counters
    assert len(res.lines) > 0


# name: (capture function, S, n_valid, block_base)
FRONT_CASES = {
    "frames_S1": (captures.noisy_frames, 1, T, 0),
    "mixed_tail_S37": (captures.mixed, 37, T - 333, 77),
    "garbage_nv35_S37": (captures.garbage, 37, 35, 5),
    "mixed_nv1_S256": (captures.mixed, 256, 1, 0),
    "mixed_nv0_S256": (captures.mixed, 256, 0, 0),
    "wrap_S129": (captures.wrong_size_and_crc, 129, T, 2**31 - 1000),
}


def _front_inputs(cuda, case):
    build, s, nv, base = FRONT_CASES[case]
    x = torch.from_numpy(build(s, T, seed=len(case))).to(cuda)
    hist = torch.from_numpy(captures.garbage(s, 36, seed=1)
                            .astype(np.float32)).to(cuda)
    return x, nv, hist, init_carry(s, cuda).dpll, base


@pytest.mark.parametrize("case", sorted(FRONT_CASES))
def test_frontend_kernel_matches_plain(cuda, case):
    x, nv, hist, dpll, base = _front_inputs(cuda, case)
    before = fused.frontend_fused.launches
    k = fused.frontend_fused(x, nv, hist, dpll, base)
    assert fused.frontend_fused.launches == before + 1
    p = fused.frontend_fused_reference(x, nv, hist, dpll, base)
    torch.cuda.synchronize()
    _assert_same(k, p)


@pytest.mark.parametrize("case", sorted(FRONT_CASES))
def test_dpll_kernel_matches_plain(cuda, case):
    """On the exact FIR of the same captures; the raw bits agree, not
    only where a bit was emitted."""
    x, nv, hist, dpll, _ = _front_inputs(cuda, case)
    filtered, _ = fir.fir_exact(x, hist, n_valid=nv)
    before = fused.dpll_fused.launches
    k = fused.dpll_fused(filtered, nv, dpll)
    assert fused.dpll_fused.launches == before + 1
    p = fused.dpll_fused_reference(filtered, nv, dpll)
    torch.cuda.synchronize()
    _assert_same(k, p)


def test_frontend_and_dpll_kernels_chained(cuda):
    s = 37
    x = captures.mixed(s, 3 * T, seed=9)
    kh = ph = init_carry(s, cuda).history
    kd = pd = kd4 = pd4 = init_carry(s, cuda).dpll
    for b in range(3):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * T:(b + 1) * T])).to(cuda)
        nv = T if b < 2 else T - 333
        k = fused.frontend_fused(xb, nv, kh, kd, b * T)
        p = fused.frontend_fused_reference(xb, nv, ph, pd, b * T)
        _assert_same(k, p)
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        filtered, _ = fir.fir_exact(xb, torch.zeros_like(kh), n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        _assert_same(k4, p4)
        kd4, pd4 = k4[2], p4[2]


def test_kernels_on_fixture_blocks(cuda):
    """B1, B3 and B4 on the blocks the command line's kernel backends
    give them for the fixture: one stream, 1020 samples padded to 1024
    and a 990-sample tail, each side chained through its own state."""
    from pathlib import Path
    audio = np.fromfile(Path(__file__).parent / "fixtures" /
                        "standard_capture.raw", dtype="<i2")
    c = init_carry(1, cuda)
    ck = cp = c
    kh, kd, ph, pd = c.history, c.dpll, c.history, c.dpll
    fh, kd4, pd4 = c.history, c.dpll, c.dpll
    frames = 0
    for off in range(0, len(audio), 1020):
        blk = audio[off:off + 1020]
        nv = len(blk)
        xb = np.zeros((1, 1024), dtype=np.int16)
        xb[0, :nv] = blk
        x = torch.from_numpy(xb).to(cuda)
        k = fused.pipeline_fused_compact(x, nv, ck.history, ck.dpll, ck.hdlc,
                                         frame_slots=32)
        p = fused.pipeline_fused_compact_reference(
            x, nv, cp.history, cp.dpll, cp.hdlc, frame_slots=32)
        _assert_same(k, p)
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])
        frames += int(k[0].sum())
        k = fused.frontend_fused(x, nv, kh, kd)
        p = fused.frontend_fused_reference(x, nv, ph, pd)
        _assert_same(k, p)
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        filtered, fh = fir.fir_exact(x, fh, n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        _assert_same(k4, p4)
        kd4, pd4 = k4[2], p4[2]
    assert nv == 990 and frames == 49


def test_new_kernels_reject_mismatched_state(cuda):
    x = torch.zeros((8, 1024), dtype=torch.int16, device=cuda)
    before = (fused.frontend_fused.launches, fused.dpll_fused.launches)
    for c in (init_carry(4, cuda), init_carry(8, "cpu")):
        with pytest.raises(ValueError):
            fused.frontend_fused(x, 1024, c.history, c.dpll)
        with pytest.raises(ValueError):
            fused.dpll_fused(x.float(), 1024, c.dpll)
    with pytest.raises(TypeError):
        fused.dpll_fused(x, 1024, init_carry(8, cuda).dpll)
    assert (fused.frontend_fused.launches, fused.dpll_fused.launches) == before


@pytest.mark.parametrize("flag", ["fast_dpll", "fused_frontend"])
def test_kernel_branch_on_card_matches_cpu(cuda, flag):
    s = 64
    x = captures.mixed(s, 3 * T, seed=12)
    out = []
    for dev in (cuda, torch.device("cpu")):
        c = init_carry(s, dev)
        leaves = []
        for b in range(3):
            nv = T if b < 2 else T - 333
            c, f, p = decode_block(
                torch.from_numpy(np.ascontiguousarray(x[:, b * T:(b + 1) * T])).to(dev),
                nv, c, frame_slots=16, block_base=b * T, **{flag: True})
            leaves += [t.cpu() for t in _flat((c, f, p))]
        out.append(leaves)
    _assert_same(out[0], out[1])


@pytest.mark.parametrize("flags", [
    dict(fused_frontend=True), dict(fast_dpll=True),
    dict(fused_pipeline=True, device_crc=True, superblock=3)])
def test_pipelined_decoder_on_card_matches_cpu(cuda, flags):
    s = 16
    x = captures.mixed(s, 5 * T, seed=13)
    blocks = [x[:, b * T:(b + 1) * T] for b in range(5)]
    res = []
    for dev in (cuda, "cpu"):
        dec = PipelinedDecoder(s, block_len=T, frame_slots=16, depth=2,
                               device=dev, **flags)
        sb = dec.superblock
        subs = [np.concatenate(blocks[i:i + sb], axis=1)
                for i in range(0, 5, sb)]
        got = dec.run(subs)
        res.append(([[[f.payload_bits.tobytes() for f in lst] for lst in r]
                     for r in got], [vars(c) for c in dec.counters]))
    assert res[0] == res[1]
    assert sum(c["receivedframes"] for c in res[0][1]) > s


# the deframer kernel (csrc/hdlc.cu): (maker, S, T, n_valid of each
# chained block, block base, lost2 window, odd-pitch views)
HDLC_CASES = {
    "S1_T1000": (captures.mixed, 1, 1000, (1000, 0, 1000), 0, None, False),
    "S37_T1000_short": (captures.mixed, 37, 1000, (1000, 20, 667), 77, None,
                        False),
    "S33_T1024_straddle": (captures.mixed, 33, 1024, (1024,) * 3,
                           2**31 - 1500, None, False),
    "S40_T8192": (captures.noisy_frames, 40, 8192, (8192 - 333,), 5, None,
                  False),
    "S256_lost2_window": (captures.wrong_size_and_crc, 256, T, (T,), 1000,
                          (1000 + 600, 1000 + 3000), False),
    "S64_minimal_frames": (captures.minimal_frames, 64, T, (T, 2001), 0, None,
                           False),
    "S37_odd_pitch": (captures.mixed, 37, 1000, (1000, 500), 3, None, True),
}


def _odd(x: torch.Tensor) -> torch.Tensor:
    wide = torch.zeros((x.shape[0], x.shape[1] + 5), dtype=x.dtype,
                       device=x.device)
    wide[:, 3:3 + x.shape[1]] = x
    return wide[:, 3:3 + x.shape[1]]


@pytest.mark.parametrize("form", ["group", "sample", "slots"])
@pytest.mark.parametrize("case", sorted(HDLC_CASES))
def test_hdlc_kernel_matches_plain(cuda, case, form):
    """The deframer kernel over chained blocks of B3's group codes, B4's
    sample codes or [S, M] slots against its plain version, every
    candidate, counter and carry leaf bitwise; B3 and B4 against theirs
    on the way."""
    build, s, t, nvs, base0, window, odd = HDLC_CASES[case]
    view = _odd if odd else (lambda v: v)
    x = build(s, len(nvs) * t, seed=s + t)
    lo, hi = window or (None, None)
    c0 = init_carry(s, cuda)
    kh, kd, fh, kd4, kq, pq = (c0.history, c0.dpll, c0.history, c0.dpll,
                               c0.hdlc, c0.hdlc)
    for b, nv in enumerate(nvs):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[:, b * t:(b + 1) * t])).to(cuda)
        base = base0 + b * t
        p = fused.frontend_fused_reference(xb, nv, kh, kd, base)
        codes, kh, kd = fused.frontend_codes(view(xb), nv, kh, kd)
        _assert_same((*fused._group_slots(codes, base), kh, kd), p)
        filtered, fh = fir.fir_exact(xb, fh, n_valid=nv)
        p4 = fused.dpll_fused_reference(filtered, nv, kd4)
        scodes, kd4 = fused.dpll_codes(view(filtered), nv, kd4)
        ct = scodes.t()
        _assert_same((ct >= 2, (ct & 1).to(torch.int32), kd4), p4)
        if form == "slots":
            kw = dict(bitrows=p[0], slot_valid=p[1], pos_rows=p[2])
        else:
            kw = dict(codes=codes if form == "group" else scodes, form=form,
                      block_base=base)
        ref = fused.hdlc_fused_reference(pq, lost2_lo=lo, lost2_hi=hi, **kw)
        if "codes" in kw:
            kw["codes"] = view(kw["codes"])
        before = fused.hdlc_fused.launches
        k = fused.hdlc_fused(kq, lost2_lo=lo, lost2_hi=hi, **kw)
        assert fused.hdlc_fused.launches == before + 1
        torch.cuda.synchronize()
        _assert_same(k, ref)
        kq, pq = k[0], ref[0]


def _forbid_plain_versions(mp):
    """The plain versions that the card routes must not reach, made to
    raise through the MonkeyPatch ``mp``: the per-sample DPLL loop, the
    per-slot deframer loop, the group reduce, the wrappers' plain
    versions."""
    from gnuais_tpu_torch.ops import demod

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a card route")
    for mod, name in ((demod, "dpll_scan"),
                      (demod, "hdlc_scan_candidates_reference"),
                      (demod, "group_reduce_bits"),
                      (fused, "frontend_fused_reference"),
                      (fused, "dpll_fused_reference"),
                      (fused, "hdlc_fused_reference")):
        mp.setattr(mod, name, plain)


@pytest.mark.parametrize("flag", ["fast_dpll", "fused_frontend", "exact"])
def test_card_route_runs_no_plain_loop(cuda, flag):
    """decode_block's unfused branches on the card against the CPU's
    plain chain, three chained blocks, bitwise, with every plain loop
    made to raise on the card run; each block launches its front-end
    kernel and the deframer once."""
    s = 64
    x = captures.mixed(s, 3 * T, seed=14)
    flags = {} if flag == "exact" else {flag: True}
    front = (fused.frontend_fused if flag == "fused_frontend"
             else fused.dpll_fused)
    out = []
    for dev in ("cpu", cuda):
        c = init_carry(s, dev)
        leaves = []
        with pytest.MonkeyPatch.context() as mp:
            if dev != "cpu":
                _forbid_plain_versions(mp)
            before = (front.launches, fused.hdlc_fused.launches)
            for b in range(3):
                nv = T if b < 2 else T - 333
                c, f, p = decode_block(
                    torch.from_numpy(np.ascontiguousarray(
                        x[:, b * T:(b + 1) * T])).to(dev),
                    nv, c, frame_slots=16, block_base=b * T, lost2_lo=500,
                    lost2_hi=9000, **flags)
                leaves += [t.cpu() for t in _flat((c, f, p))]
            if dev != "cpu":
                assert (front.launches, fused.hdlc_fused.launches) == \
                    (before[0] + 3, before[1] + 3)
        out.append(leaves)
    _assert_same(out[1], out[0])


@pytest.mark.parametrize("backend", ["exact", "fast", "fused_frontend"])
def test_card_routes_on_fixture_blocks(cuda, backend):
    """The fixture's chained blocks as the command line gives them (one
    stream; ``exact``: 1020-sample blocks; the others 1020 samples
    padded to 1024, 73 blocks with a 990-sample tail) through the card
    routes, against the plain chain on the CPU: every frame and carry
    leaf; 49 frames."""
    from pathlib import Path
    audio = np.fromfile(Path(__file__).parent / "fixtures" /
                        "standard_capture.raw", dtype="<i2")
    width = 1020 if backend == "exact" else 1024
    flags = {"exact": {}, "fast": dict(fast_dpll=True),
             "fused_frontend": dict(fused_frontend=True)}[backend]
    ck, cp = init_carry(1, cuda), init_carry(1, "cpu")
    frames = blocks = 0
    for off in range(0, len(audio), 1020):
        blk = audio[off:off + 1020]
        xb = np.zeros((1, width), dtype=np.int16)
        xb[0, :len(blk)] = blk
        ck, kf, kp = decode_block(torch.from_numpy(xb).to(cuda), len(blk), ck,
                                  frame_slots=32, **flags)
        cp, pf, pp = decode_block(torch.from_numpy(xb), len(blk), cp,
                                  frame_slots=32, **flags)
        _assert_same([t.cpu() for t in _flat((ck, kf, kp))], _flat((cp, pf, pp)))
        frames += int(kf.count.sum())
        blocks += 1
    assert (blocks, frames) == (73, 49)


# the throughput modes' shapes: (kernel, T); B1 with the lanes' 64 frame
# slots, T = 56,320 (streams 4096 over 70 minutes) and 72,704 (the default
# chunk_len); B2 at the 1 x 1 session's T = 4096 + 49,152 + 3072
THROUGHPUT_SHAPES = {"B1_T56320": ("B1", 56_320), "B1_T72704": ("B1", 72_704),
                     "B2_T56320": ("B2", 56_320)}


@pytest.mark.parametrize("case", sorted(THROUGHPUT_SHAPES))
def test_kernels_at_the_throughput_shapes(cuda, case):
    kind, t = THROUGHPUT_SHAPES[case]
    s = 37
    x = torch.from_numpy(captures.mixed(s, t, seed=t)).to(cuda)
    c = init_carry(s, cuda)
    c = c._replace(history=torch.from_numpy(
        captures.garbage(s, FIR_LEN, seed=t + 1).astype(np.float32)).to(cuda))
    kw = dict(block_base=4097, lost2_lo=8193, lost2_hi=4097 + t - 3072)
    args = (x, t - 333, c.history, c.dpll, c.hdlc)
    if kind == "B1":
        k, p = _pair(*args[:2], c, frame_slots=64, **kw)
    else:
        before = fused.pipeline_fused.launches
        k = fused.pipeline_fused(*args, **kw)
        assert fused.pipeline_fused.launches == before + 1
        p = fused.pipeline_fused_reference(*args, **kw)
    _assert_same(k, p)
    assert int(k[0].sum()) > 0


def _rows_stream(n_rows: int, t: int, seed: int) -> np.ndarray:
    """n_rows noisy encoder captures of t samples laid end to end."""
    return captures.noisy_frames(n_rows, t, seed=seed).reshape(-1)


def test_lanes_on_card_match_cpu(cuda):
    """time_parallel_decode on 64 lanes: kernel B1 on the card (one
    launch) gives the CPU plain version's frames and counters, through
    the dense and the slot drain."""
    from gnuais_tpu_torch.parallel.timepar import time_parallel_decode
    stream = _rows_stream(64, 8192, seed=3)
    for cap in (8192, 4):
        before = fused.pipeline_fused_compact.launches
        card = time_parallel_decode(stream, chunk_len=8192, dense_cap=cap,
                                    device=cuda)
        assert fused.pipeline_fused_compact.launches == before + 1
        cpu = time_parallel_decode(stream, chunk_len=8192, dense_cap=cap,
                                   device="cpu")
        assert card.chunks == 64 and len(card.frames) > 64
        assert (card.starts, card.ends, card.wrong_crc, card.wrong_size,
                card.peak) == (cpu.starts, cpu.ends, cpu.wrong_crc,
                               cpu.wrong_size, cpu.peak)
        assert [f.payload_bits.tobytes() for f in card.frames] == \
            [f.payload_bits.tobytes() for f in cpu.frames]


def test_session_on_card_matches_cpu(cuda):
    """TimeParSession on a 1 x 1 grid of the card, 64 rows, 4096-sample
    super-blocks: kernel B2 once a decoded block, the CPU's frames and
    counters, and a snapshot that restores."""
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    x = captures.noisy_frames(64, 4 * 4096, seed=4)
    res = []
    for dev in (cuda, "cpu"):
        sess = TimeParSession(make_grid_mesh(1, 1, device=dev), 64, 4096)
        before = fused.pipeline_fused.launches
        got = []
        for b in range(4):
            out = sess.push(x[:, b * 4096:(b + 1) * 4096])
            if out:
                got.append(out)
        got.append(sess.flush(n_valid=4000))
        if dev == cuda:
            assert fused.pipeline_fused.launches == before + 4
        res.append(([[(s, e, f.payload_bits.tobytes()) for s, e, f in lst]
                     for out in got for lst in out],
                    (sess.received, sess.wrong_crc, sess.wrong_size,
                     sess.last_peak)))
    assert res[0] == res[1]
    assert sum(res[0][1][0]) > 64


def test_iq_front_end_on_card_matches_cpu(cuda, tmp_path):
    """The IQ reader on the card: its int16 audio within one count of the
    CPU's on at most 1 sample in 1000 (atan2's last bit)."""
    from gnuais_tpu_torch.io.iq import IqStreamReader
    rng = np.random.default_rng(6)
    iq = np.exp(1j * np.cumsum(rng.normal(0, 0.3, 2 * 4 * 50_000))) \
        .astype(np.complex64)
    raw = np.empty(2 * len(iq), dtype="<f4")
    raw[0::2], raw[1::2] = iq.real, iq.imag
    path = tmp_path / "x.iq"
    raw.tofile(path)
    a = IqStreamReader(path, channels=2, device=cuda).read_all()
    b = IqStreamReader(path, channels=2, device="cpu").read_all()
    d = a.astype(np.int32) - b.astype(np.int32)
    assert a.shape == b.shape == (100_000,)
    assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= len(d) // 1000


def _cards(n: int):
    """The first n cards, or a skip where there are fewer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, has "
                    f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def two_cards():
    return _cards(2)


@pytest.fixture
def four_cards():
    return _cards(4)


def _grid_session(mesh, x, sb):
    """TimeParSession over ``mesh`` on the rows x in pushes of sb, a short
    final block; returns (frames, counters) and the B2 launches."""
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    sess = TimeParSession(mesh, x.shape[0], sb)
    before = fused.pipeline_fused.launches
    got = []
    for b in range(x.shape[1] // sb):
        out = sess.push(x[:, b * sb:(b + 1) * sb])
        if out:
            got.append(out)
    got.append(sess.flush(n_valid=sb - 96))
    flat = [[(s, e, f.payload_bits.tobytes()) for s, e, f in lst]
            for out in got for lst in out]
    return ((flat, (sess.received, sess.wrong_crc, sess.wrong_size,
                    sess.last_peak)),
            fused.pipeline_fused.launches - before)


def test_grid_repeated_on_one_card_matches_cpu(cuda):
    """A 2 x 2 grid whose four shards all lie on one card (a device list
    may repeat a card): kernel B2 once a shard a decoded block, the CPU
    grid's frames and counters."""
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    x = captures.noisy_frames(64, 4 * 8192, seed=9)
    card, n_card = _grid_session(make_grid_mesh(2, 2, devices=[cuda] * 4),
                                 x, 8192)
    cpu, _ = _grid_session(make_grid_mesh(2, 2, device="cpu"), x, 8192)
    assert n_card == 4 * 4
    assert card == cpu and sum(card[1][0]) > 64


def test_b2_launches_on_a_second_card(two_cards):
    """Kernel B2 on cuda:1 while cuda:0 is the current device: the launch
    runs there, its outputs lie there and equal the plain version's, and
    decode_block and the stream-sharded step keep everything on the
    card they were given."""
    from gnuais_tpu_torch.parallel.mesh import make_stream_mesh
    from gnuais_tpu_torch.parallel.sharded import make_sharded_decode
    dev = two_cards[1]
    torch.cuda.set_device(0)
    x = torch.from_numpy(captures.mixed(37, T, seed=11)).to(dev)
    c = init_carry(37, dev)
    args = (x, T - 333, c.history, c.dpll, c.hdlc)
    before = fused.pipeline_fused.launches
    k = fused.pipeline_fused(*args, block_base=77)
    assert fused.pipeline_fused.launches == before + 1
    assert all(t.device == dev for t in _flat(k))
    _assert_same(k, fused.pipeline_fused_reference(*args, block_base=77))
    carry, frames, peak = decode_block(x, T, c, fused_pipeline=True,
                                       device_crc=True)
    assert all(t.device == dev for t in _flat((carry, frames, peak)))
    step = make_sharded_decode(make_stream_mesh(2, devices=two_cards[::-1]),
                               fused_pipeline=True)
    xs = x[:36]
    c2, f2, p2 = step(xs, T, init_carry(36, dev))
    c1, f1, p1 = decode_block(xs, T, init_carry(36, dev),
                              fused_pipeline=True)
    assert f2.count.device == dev
    _assert_same((c2, f2, p2), (c1, f1, p1))


def test_grid_2x2_on_four_cards_matches_cpu(four_cards):
    """A 2 x 2 grid on four cards (halos between cards) gives the CPU
    grid's frames and counters, kernel B2 on each card."""
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    x = captures.noisy_frames(64, 4 * 8192, seed=12)
    mesh = make_grid_mesh(2, 2, devices=four_cards)
    card, n_card = _grid_session(mesh, x, 8192)
    cpu, _ = _grid_session(make_grid_mesh(2, 2, device="cpu"), x, 8192)
    assert n_card == 4 * 4
    assert card == cpu and sum(card[1][0]) > 64


@pytest.mark.parametrize("layout", ["row", "time"])
def test_b2_prefiltered_on_card_matches_plain(cuda, layout):
    """B2's prefiltered mode (csrc/pipeline_fused.cu) on the exact FIR of
    a capture against its plain version, every leaf, the history handed
    back; its frames and carry those of B2 on the raw samples."""
    s = 37
    x = torch.from_numpy(captures.mixed(s, T, seed=31)).to(cuda)
    c = init_carry(s, cuda)
    filt = fir.fir_exact(x, c.history)[0]
    kw = dict(block_base=9, prefiltered=True)
    xin = filt.t().contiguous() if layout == "time" else filt
    if layout == "time":
        kw.update(pretiled_streams=s)
    k = fused.pipeline_fused(xin, T - 333, c.history, c.dpll, c.hdlc, **kw)
    p = fused.pipeline_fused_reference(filt, T - 333, c.history, c.dpll,
                                       c.hdlc, block_base=9, prefiltered=True)
    _assert_same(k, p)
    assert k[7] is c.history
    r = fused.pipeline_fused(x, T - 333, c.history, c.dpll, c.hdlc,
                             block_base=9)
    _assert_same(k[:7] + k[8:], r[:7] + r[8:])


@pytest.mark.parametrize("fir_mode", ["vpu", "lobe"])
def test_b2_body_landing_on_card_matches_slot(cuda, fir_mode):
    """B1's and B2's landing (a frame landed once after its 32-sample
    chunk, csrc/pipeline_kernel.cuh) bitwise equal to the plain version,
    which lands each frame at its emission slot, on minimal back-to-back
    frames."""
    s = 64
    x = torch.from_numpy(captures.minimal_frames(s, T, seed=3)).to(cuda)
    c = init_carry(s, cuda)
    args = (x, T, c.history, c.dpll, c.hdlc)
    b2 = fused.pipeline_fused(*args, fir_mode=fir_mode)
    _assert_same(b2, fused.pipeline_fused_reference(*args, fir_mode=fir_mode))
    assert int(b2[0].sum()) > 0
    b1 = fused.pipeline_fused_compact(*args, frame_slots=32,
                                      fir_mode=fir_mode)
    _assert_same(b1, fused.pipeline_fused_compact_reference(
        *args, frame_slots=32, fir_mode=fir_mode))


@pytest.mark.parametrize("strip", sorted(fused.STRIP_FLAGS))
def test_b2_strip_on_card_holds_its_invariant(cuda, strip):
    """Each strip variant (csrc/pipeline_strip.cu, its own library) held
    by diag_strip.check_strip against the unstripped kernel."""
    from gnuais_tpu_torch import diag_strip
    s = 37
    x = torch.from_numpy(captures.wrong_size_and_crc(s, T, seed=9)).to(cuda)
    c = init_carry(s, cuda)
    args = (x, T, c.history, c.dpll, c.hdlc)
    out = fused.pipeline_fused(*args, strip=strip)
    ref = fused.pipeline_fused(*args)
    fir_ref = (fused.pipeline_fused(x.to(torch.float32), *args[1:],
                                    prefiltered=True)
               if strip == "fir" else None)
    diag_strip.check_strip(strip, out, ref, c, fir_ref)
