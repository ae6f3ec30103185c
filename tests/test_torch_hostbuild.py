"""Kernels B1, B2, B3, B4, the deframer and the mxu probe as host C++
(``gnuais_tpu_torch.hostbuild``): the kernel bodies of ``csrc/``
themselves (the FIR producer warps, the ring's barriers and copies, the
chain consumer warps, the deframer's tile ring) run on the CPU, one
std::thread per CUDA thread, through the wrappers' launch functions,
against the plain versions: every output and carry leaf bitwise, in
every FIR mode and both input layouts (time-major; row-major, with a
pitch that does or does not allow 16-byte copies), at S = 1 to 64, T =
1000 to 8192, over chained blocks.  Skips only where there is no
``g++``.
"""

import numpy as np
import pytest
import torch

from gnuais_tpu_torch import captures, hostbuild
from gnuais_tpu_torch.constants import FIR_LEN, FIR_TAPS
from gnuais_tpu_torch.ops import demod, fir, fused
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


# B3, B4 and the deframer: (maker, S, T, n_valid of each chained block,
# block base, lost2 window, input layout)
FRONT = {
    # one stream; a block that only freezes the carry
    "S1_T1000": (captures.mixed, 1, 1000, (1000, 0, 1000), 0, None, "row"),
    # S not a multiple of 32; M = 250 slots, not a multiple of 64;
    # n_valid short, then T
    "S37_T1000_short": (captures.mixed, 37, 1000, (1000, 20, 667), 77, None,
                        "row"),
    # frames that straddle the seams of 1024-sample blocks, positions
    # that cross the int32 wrap
    "S33_T1024_straddle": (captures.mixed, 33, 1024, (1024, 1024, 1024),
                           2**31 - 1500, None, "row"),
    "S40_T8192": (captures.noisy_frames, 40, 8192, (8192 - 333,), 5, None,
                  "row"),
    # a lost2 window over wrong-size stops and CRC rejects
    "S37_lost2_window": (captures.wrong_size_and_crc, 37, 4096, (4096,), 1000,
                         (1000 + 600, 1000 + 3000), "row"),
    # back-to-back minimal frames, the densest completions the deframer
    # permits (MINI_SLOTS in a 64-slot chunk; a third cannot fit, so
    # `over` stays 0 on both sides), with n_valid mid-frame
    "S64_minimal_frames": (captures.minimal_frames, 64, 4096, (4096, 2001),
                           0, None, "row"),
    # the raw block, and B3's and B4's codes, read from views with an
    # odd pitch and offset: no 16-byte copies anywhere
    "S37_odd_pitch": (captures.mixed, 37, 1000, (1000, 500), 3, None, "odd"),
}


def _view(x: torch.Tensor, layout: str) -> torch.Tensor:
    """``x`` [R, C] as it is, or as a view with an odd pitch inside a
    wider tensor."""
    if layout == "row":
        return x
    wide = torch.zeros((x.shape[0], x.shape[1] + 5), dtype=x.dtype)
    wide[:, 3:3 + x.shape[1]] = x
    return wide[:, 3:3 + x.shape[1]]


@pytest.mark.parametrize("kernel", ["B3", "B4", "hdlc_group", "hdlc_sample",
                                    "hdlc_slots"])
@pytest.mark.parametrize("case", sorted(FRONT))
def test_front_and_deframer_bodies_match_plain(host, case, kernel):
    """Each kernel against its plain version over the case's chained
    blocks, each side chained through its own carry: B3
    (``frontend_codes``) against ``frontend_fused_reference``, B4
    (``dpll_codes``) against ``dpll_fused_reference`` on the exact FIR,
    and the deframer (``hdlc_fused``) on B3's group codes, B4's sample
    codes and [S, M] slots against ``hdlc_fused_reference``, every
    candidate, counter and carry leaf."""
    maker, s, t, nvs, base0, window, layout = FRONT[case]
    x = maker(s, len(nvs) * t, seed=s + t)
    lo, hi = window or (None, None)
    c0 = init_carry(s, "cpu")
    kh, kd, ph, pd = c0.history, c0.dpll, c0.history, c0.dpll    # B3
    fh, kd4, pd4 = c0.history, c0.dpll, c0.dpll                   # B4
    kq = pq = c0.hdlc                                             # deframer
    for b, nv in enumerate(nvs):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * t:(b + 1) * t]))
        base = base0 + b * t
        codes, kh, kd = fused.frontend_codes(_view(xb, layout), nv, kh, kd)
        p = fused.frontend_fused_reference(xb, nv, ph, pd, base)
        if kernel == "B3":
            _assert_same((*fused._group_slots(codes, base), kh, kd), p)
        ph, pd = p[3], p[4]
        filtered, fh = fir.fir_exact(xb, fh, n_valid=nv)
        scodes, kd4 = fused.dpll_codes(_view(filtered, layout), nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        if kernel == "B4":
            ct = scodes.t()
            _assert_same((ct >= 2, (ct & 1).to(torch.int32), kd4), p4)
        pd4 = p4[2]
        if not kernel.startswith("hdlc"):
            continue
        form = kernel.split("_")[1]
        kw = dict(lost2_lo=lo, lost2_hi=hi)
        if form == "slots":
            kw.update(bitrows=p[0], slot_valid=p[1], pos_rows=p[2])
            given = None
        else:
            given = codes if form == "group" else scodes
            kw.update(block_base=base)
        before = fused.hdlc_fused.launches
        k = fused._launch_hdlc(
            kq, form, None if given is None else _view(given, layout),
            kw.get("bitrows"), kw.get("slot_valid"), kw.get("pos_rows"),
            kw.get("block_base", 0), lo, hi)
        assert fused.hdlc_fused.launches == before + 1
        ref = fused.hdlc_fused_reference(pq, given, form, **kw)
        _assert_same(k, ref)
        assert int(ref[1].over.sum()) == 0
        kq, pq = k[0], ref[0]


def _dense_bits(s: int, m: int) -> np.ndarray:
    """[S, M] bit slots of back-to-back shortest frames: 17 alternations,
    the start flag, 20 zeros and the stop flag, 51 slots a frame (the
    completions of a 64-slot chunk: up to MINI_SLOTS), the phase moving
    from row to row."""
    flag = [1, 1, 1, 1, 1, 1, 0]
    unit = [0, 1] * 8 + [0] + flag + [0] * 20 + flag
    rows = np.empty((s, m), dtype=np.int32)
    for i in range(s):
        seq = [1] * (i % 51) + unit * (m // len(unit) + 2)
        rows[i] = seq[:m]
    return rows


@pytest.mark.parametrize("form", ["group", "sample", "slots"])
@pytest.mark.parametrize("s,m", [(1, 1000), (37, 4096), (64, 250)])
def test_deframer_body_dense_completions(host, s, m, form):
    """The deframer kernel where chunks hold MINI_SLOTS completions (the
    second lands in the chunk's second candidate slot), every slot valid
    but a gap of invalid ones, from each input form, against the plain
    version, with a lost2 window."""
    bits = _dense_bits(s, m)
    valid = np.ones((s, m), dtype=bool)
    valid[:, m // 3:m // 3 + 7] = False
    base = 11
    if form == "group":
        codes = torch.from_numpy(((valid << 3) | (bits << 2) | 2).astype(np.uint8).T
                                 .copy())
        given = dict(codes=codes)
    elif form == "sample":
        sc = np.zeros((4 * m, s), dtype=np.uint8)
        sc[1::4] = np.where(valid, 2 + bits, 0).T
        given = dict(codes=torch.from_numpy(sc))
    else:
        pos = (base + 4 * np.arange(m) + 1)[None, :].repeat(s, 0)
        given = dict(bitrows=torch.from_numpy(bits),
                     slot_valid=torch.from_numpy(valid),
                     pos_rows=torch.from_numpy(pos.astype(np.int32)))
    state = init_carry(s, "cpu").hdlc
    window = dict(lost2_lo=base + 400, lost2_hi=base + 3000)
    k = fused._launch_hdlc(state, form, given.get("codes"),
                           given.get("bitrows"), given.get("slot_valid"),
                           given.get("pos_rows"), base, **window)
    ref = fused.hdlc_fused_reference(state, form=form, block_base=base,
                                     **given, **window)
    _assert_same(k, ref)
    cand = ref[1].valid.reshape(s, -1, 2)
    assert bool(cand.all(dim=2).any()) == (m >= 128)
    assert int(ref[1].over.sum()) == 0


# ---------------------------------------------------------------------------
# B1's and B2's landing, B2's prefiltered mode and strip variants
# ---------------------------------------------------------------------------

def _b2(rows, pretiled, nv, c, mode="vpu", **kw):
    return fused._launch_pipeline(fused.pipeline_fused, rows, pretiled, nv,
                                  c.history, c.dpll, c.hdlc,
                                  fused.n_candidates(rows.shape[1]), 5, mode,
                                  None, None, **kw)


@pytest.fixture(scope="module")
def prefiltered_blocks():
    """Three chained blocks (n_valid T, 20, 0) of a noisy capture from a
    carried history: per block (raw int16, its exact FIR, n_valid, the
    carry in, the plain prefiltered B2's outputs), the carry chained as
    the raw samples' (the FIR history of the raw block)."""
    s = 37
    x = captures.mixed(s, 3 * T, seed=11)
    c = init_carry(s, "cpu")
    c = c._replace(history=torch.from_numpy(
        captures.garbage(s, FIR_LEN, seed=12).astype(np.float32)))
    out = []
    for b, nv in enumerate((T, 20, 0)):
        raw = torch.from_numpy(np.ascontiguousarray(x[:, b * T:(b + 1) * T]))
        filt, history = fir.fir_exact(raw, c.history, n_valid=nv)
        p = fused.pipeline_fused_reference(filt, nv, c.history, c.dpll,
                                           c.hdlc, block_base=5,
                                           prefiltered=True)
        out.append((raw, filt, nv, c, p))
        c = PipelineCarry(history, *p[8:])
    return out


@pytest.mark.parametrize("layout", ["time", "row", "row_unaligned"])
def test_prefiltered_body_matches_plain(host, prefiltered_blocks, layout):
    """B2's prefiltered producers (float32 chunks copied into the ring,
    16-byte copies where aligned) against the plain version over three
    chained blocks, every leaf, the history handed back as it came; the
    frames and carry those of B2 on the raw samples."""
    for raw, filt, nv, c, p in prefiltered_blocks:
        if layout == "time":
            rows, pretiled = filt.t().contiguous().t(), True
        elif layout == "row":
            rows, pretiled = filt, False
        else:
            wide = torch.zeros((filt.shape[0], T + 5), dtype=torch.float32)
            wide[:, 3:3 + T] = filt
            rows, pretiled = wide[:, 3:3 + T], False
        k = _b2(rows, pretiled, nv, c, prefiltered=True)
        _assert_same(k, p)
        assert k[7] is c.history
        r = _b2(raw, False, nv, c)
        _assert_same(k[:7] + k[8:], r[:7] + r[8:])


@pytest.mark.parametrize("fir_mode", ["vpu", "lobe"])
def test_body_landing_matches_slot_landing(host, fir_mode):
    """B1's and B2's landing (a frame latched and landed once after its
    32-sample chunk, the JAX kernel's "body" landing) bitwise equal to
    the plain version, which lands each frame at its emission slot:
    minimal back-to-back frames (the densest completions) and mixed
    captures, n_valid on and off the chunk grid, chained."""
    for maker, s in ((captures.minimal_frames, 64), (captures.mixed, 33)):
        x = maker(s, 2 * T, seed=s)
        assert int(fused.pipeline_fused_reference(
            torch.from_numpy(np.ascontiguousarray(x[:, :T])), T,
            *init_carry(s, "cpu"))[0].sum()) > 0
        for candidates in (False, True):
            _chain(x, (T - 333, T), "row", fir_mode, candidates)


@pytest.fixture(scope="module")
def strip_libs():
    """The host libraries of the single strip flags, built together."""
    if hostbuild.gxx_path() is None:
        pytest.skip("needs g++")
    hostbuild.build_strips(fused.STRIP_FLAGS.values())


@pytest.mark.parametrize("fir_mode", ["vpu", "lobe"])
@pytest.mark.parametrize("strip", sorted(fused.STRIP_FLAGS))
def test_strip_variant_holds_its_invariant(host, strip_libs, strip, fir_mode):
    """Each strip variant of B2 (``csrc/pipeline_strip.cu``) against the
    unstripped kernel on a capture with frames, wrong-size stops and CRC
    rejects, from a carried history, in two FIR modes, held by
    ``diag_strip.check_strip``:
    the DPLL carry; ``fir`` equal to prefiltered B2 on the raw samples
    cast to float32, every leaf; the HDLC state; the counts."""
    from gnuais_tpu_torch import diag_strip
    s = 37
    x = torch.from_numpy(captures.wrong_size_and_crc(s, 4096, seed=9))
    c = init_carry(s, "cpu")
    c = c._replace(history=torch.from_numpy(
        captures.garbage(s, FIR_LEN, seed=10).astype(np.float32)))
    mask = fused.STRIP_FLAGS[strip]
    before = fused.pipeline_fused.mode_launches["strip"]
    out = _b2(x, False, 4000, c, fir_mode, strip=mask)
    assert fused.pipeline_fused.mode_launches["strip"] == before + 1
    ref = _b2(x, False, 4000, c, fir_mode)
    fir_ref = (_b2(x.to(torch.float32), False, 4000, c, prefiltered=True)
               if strip == "fir" else None)
    assert int(ref[0].sum()) > 0 and int(ref[5].sum()) > 0
    diag_strip.check_strip(strip, out, ref, c, fir_ref)
