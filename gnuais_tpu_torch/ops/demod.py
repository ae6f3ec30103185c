"""Exact batched demodulation: DPLL clock recovery and HDLC deframing
(counterpart of ``gnuais_tpu/ops/demod.py``).

Bit-identical to the reference's per-sample loops (receiver.c:109-135
DPLL/slicer/NRZI, protodec.c:988-1122 HDLC), vectorised over a
``streams`` axis.  Time stays a Python loop over [S]-wide tensor ops:
this is the plain PyTorch version that the CUDA kernels (``ops/fused.py``)
are held against, and the port's CPU decode.  On a CUDA tensor
``hdlc_scan_candidates`` (and so ``hdlc_scan``) launches the deframer
kernel (``fused.hdlc_fused``, ``csrc/hdlc.cu``) instead of its plain
version ``hdlc_scan_candidates_reference``.

torch has no ``<<``, ``>>`` or comparisons for ``uint32`` on the CPU, so
the 15x32-bit register words are carried as ``int32`` holding the same
bit pattern (masked after each ``>>``).  ``convert.py`` turns them into
``uint32`` at the numpy boundary.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import constants as C

# Shift register geometry: 15 x 32 = 480 bits >= 449-bit buffer cap.
REG_WORDS = 15
REG_BITS = REG_WORDS * 32

# Frame completions are at least ~47 bit slots apart (a new frame needs
# >14 hunt alternations, the start flag and >22 data bits before its
# stop flag), so a 64-slot chunk holds at most MINI_SLOTS completions.
# A completion beyond MINI_SLOTS in one chunk is dropped and counted in
# ``over``, exactly as the JAX chain does (structurally 0).
HDLC_CHUNK = 64
MINI_SLOTS = 2

_I32 = torch.int32


# ---------------------------------------------------------------------------
# DPLL
# ---------------------------------------------------------------------------

class DpllState(NamedTuple):
    pll: torch.Tensor       # [S] int32, 16-bit phase accumulator
    prev: torch.Tensor      # [S] int32, previous sample sign
    lastbit: torch.Tensor   # [S] int32, previous sliced bit (NRZI)


def init_dpll(n_streams: int, device: torch.device | str) -> DpllState:
    z = torch.zeros((n_streams,), dtype=_I32, device=device)
    return DpllState(pll=z, prev=z.clone(), lastbit=z.clone())


def dpll_scan(filtered: torch.Tensor, n_valid: int, state: DpllState
              ) -> Tuple[torch.Tensor, torch.Tensor, DpllState]:
    """filtered: float32 [S, T]; samples at index >= ``n_valid`` (the
    padding of a short final block) freeze the state and emit nothing.
    Returns (bit_valid [S, T] bool, bits [S, T] int32, state').

    Only the phase accumulator is a true recurrence; the slicer, the
    transitions and the NRZI bits follow from it vectorised."""
    s, t = filtered.shape
    nv = max(0, min(int(n_valid), t))
    dev = filtered.device
    curr = (filtered > 0).to(_I32)
    prev_seq = torch.cat([state.prev[:, None], curr[:, :-1]], dim=1)
    nudge = (curr ^ prev_seq) * C.PLL_NUDGE             # 0 or +NUDGE
    up = nudge[:, :nv].t().contiguous().unbind(0)
    down = (-nudge[:, :nv]).t().contiguous().unbind(0)
    pll = state.pll
    emits: List[torch.Tensor] = []
    for nu, nd in zip(up, down):
        # a transition nudges the phase toward the centre
        pll = pll + torch.where(pll < C.PLL_CENTER, nu, nd) + C.PLL_INC
        e = pll > 0xFFFF
        pll = pll & 0xFFFF          # pll is in [0, 2^17): the wrap
        emits.append(e)
    emit = torch.zeros((s, t), dtype=torch.bool, device=dev)
    if nv:
        emit[:, :nv] = torch.stack(emits, dim=1)

    # NRZI: bit = 1 - (curr ^ lastbit), lastbit = the slicer at the
    # last emission strictly before this sample (or the carried one)
    idx = torch.arange(t, device=dev)
    last = torch.where(emit, idx, -1).cummax(dim=1).values       # [S, T]
    before = torch.cat(
        [torch.full((s, 1), -1, dtype=last.dtype, device=dev),
         last[:, :-1]], dim=1)
    lb = torch.where(before >= 0, curr.gather(1, before.clamp(min=0)),
                     state.lastbit[:, None])
    bits = 1 - (curr ^ lb)

    fin = last[:, -1]
    new_last = torch.where(fin >= 0, curr.gather(1, fin.clamp(min=0)[:, None])[:, 0],
                           state.lastbit)
    new_prev = curr[:, nv - 1] if nv else state.prev
    return emit, bits, DpllState(pll=pll.clone(), prev=new_prev.contiguous(),
                                 lastbit=new_last)


def compact_bits(bit_valid: torch.Tensor, bits: torch.Tensor,
                 max_bits: int, block_base: int = 0):
    """Pack the emitted bits of each stream densely.

    bit_valid: bool [S, T]; bits: int [S, T].  Returns (bitrows [S,
    max_bits] int32, slot_valid [S, max_bits] bool, nbits [S] int32,
    pos_rows [S, max_bits] int32): stream s's n-th emitted bit and its
    absolute sample index (block_base + in-block time) at column n; bits
    past max_bits are dropped, nbits counts them all."""
    s, t = bits.shape
    dev = bits.device
    pos = bit_valid.to(_I32).cumsum(dim=1) - 1
    keep = bit_valid & (pos < max_bits)
    rows = torch.arange(s, device=dev)[:, None].expand(s, t)[keep]
    cols = pos[keep].long()
    bitrows = torch.zeros((s, max_bits), dtype=_I32, device=dev)
    bitrows[rows, cols] = bits[keep].to(_I32)
    sample_idx = (block_base + torch.arange(t, device=dev)).to(_I32)
    pos_rows = torch.zeros((s, max_bits), dtype=_I32, device=dev)
    pos_rows[rows, cols] = sample_idx.expand(s, t)[keep]
    nbits = bit_valid.sum(dim=1).to(_I32)
    slot_valid = torch.arange(max_bits, device=dev)[None, :] < nbits[:, None]
    return bitrows, slot_valid, nbits, pos_rows


def group_reduce_bits(bit_valid: torch.Tensor, bits: torch.Tensor,
                      block_base: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter-free bit slotting: reduce 4-sample groups.

    Consecutive DPLL emissions are at least 4 samples apart (the phase
    step is at most 13926 per sample, so 13925 + 3*13926 < 65536), hence
    every aligned 4-sample group holds at most one emitted bit.

    Returns (gbits [S, T/4] int32, gvalid [S, T/4] bool, gpos [S, T/4]
    int32 absolute sample indices, wrapping like int32)."""
    s, t = bits.shape
    if t % 4:
        raise ValueError(f"group_reduce_bits needs T % 4 == 0, got {t}")
    g = t // 4
    e = bit_valid.reshape(s, g, 4)
    gvalid = e.any(dim=2)
    gbits = (bits.reshape(s, g, 4) * e).sum(dim=2).to(_I32)
    idx = (int(block_base) + torch.arange(t, device=bits.device)).reshape(1, g, 4)
    gpos = (idx * e).sum(dim=2).to(_I32)
    return gbits, gvalid, gpos


# ---------------------------------------------------------------------------
# HDLC
# ---------------------------------------------------------------------------

class HdlcState(NamedTuple):
    state: torch.Tensor           # [S] int32 (ST_*)
    last: torch.Tensor            # [S] int32
    antallpreamble: torch.Tensor  # [S] int32
    nstartsign: torch.Tensor      # [S] int32
    antallenner: torch.Tensor     # [S] int32
    bitstuff: torch.Tensor        # [S] int32
    bufferpos: torch.Tensor       # [S] int32
    data_start: torch.Tensor      # [S] int32 sample index of ST_DATA entry
    shiftreg: torch.Tensor        # [S, REG_WORDS] int32 (uint32 bits), newest bit = LSB of word 14


class FrameBatch(NamedTuple):
    """Per-block frame outputs (reset every block)."""
    words: torch.Tensor     # [S, F, REG_WORDS] int32 (uint32 bits) register snapshots
    length: torch.Tensor    # [S, F] int32 payload bit count (bufferpos - 22)
    start: torch.Tensor     # [S, F] int32 sample index of the frame's data start
    end: torch.Tensor       # [S, F] int32 sample index of the completing stop flag
    count: torch.Tensor     # [S] int32 frames emitted
    lost2: torch.Tensor     # [S] int32 bad stop-sign frames (wrong size)
    dropped: torch.Tensor   # [S] int32 frames lost to slot overflow
    crcfail: torch.Tensor   # [S] int32 CRC rejects filtered on the device


class Candidates(NamedTuple):
    """Frame completions in arrival order, MINI_SLOTS per 64-slot chunk
    (K = n_chunks * MINI_SLOTS), before compaction into slots."""
    valid: torch.Tensor     # [S, K] bool
    words: torch.Tensor     # [S, K, REG_WORDS] int32
    length: torch.Tensor    # [S, K] int32
    start: torch.Tensor     # [S, K] int32
    end: torch.Tensor       # [S, K] int32
    lost2: torch.Tensor     # [S] int32 wrong-size stops in [lost2_lo, lost2_hi)
    over: torch.Tensor      # [S] int32 completions beyond MINI_SLOTS in a chunk


def init_hdlc(n_streams: int, device: torch.device | str) -> HdlcState:
    def z():
        return torch.zeros((n_streams,), dtype=_I32, device=device)
    return HdlcState(
        state=torch.full((n_streams,), C.ST_SKURR, dtype=_I32, device=device),
        last=z(), antallpreamble=z(), nstartsign=z(), antallenner=z(),
        bitstuff=z(), bufferpos=z(), data_start=z(),
        shiftreg=torch.zeros((n_streams, REG_WORDS), dtype=_I32,
                             device=device),
    )


def init_frames(n_streams: int, frame_slots: int,
                device: torch.device | str) -> FrameBatch:
    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)
    return FrameBatch(
        words=z(n_streams, frame_slots, REG_WORDS),
        length=z(n_streams, frame_slots), start=z(n_streams, frame_slots),
        end=z(n_streams, frame_slots),
        count=z(n_streams), lost2=z(n_streams), dropped=z(n_streams),
        crcfail=z(n_streams))


def _reg_append(reg: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Multiword shift left by one, inserting ``bit`` at the LSB of the
    last word.  reg: [S, W] int32 bit patterns; bit: [S] int32."""
    carry_in = torch.cat([(reg[:, 1:] >> 31) & 1, bit[:, None]], dim=1)
    return (reg << 1) | carry_in


def _hdlc_slot(hv: Tuple[torch.Tensor, ...], b: torch.Tensor,
               spos: torch.Tensor):
    """One HDLC bit-slot state update, all streams treated as valid
    (the caller masks).  hv: the 8 [S] int32 HdlcState variables; b: the
    slot's bit; spos: its absolute sample index.

    A re-derivation of the reference's per-bit switch
    (protodec.c:993-1121), in the merged form of the fused kernel's
    slot step (gnuais_tpu/ops/fused.py ``_hdlc_slot_tiles``): every path
    back to the noise hunt zeroes all counters through one ``hard``
    predicate.  Returns (hv', append, emit, flen, bad): ``append`` marks
    streams whose register takes this bit, ``emit`` completed frames of
    positive length, ``flen`` the payload bit count before the reset,
    ``bad`` wrong-size stop flags."""
    st, last, ap, ns, ae, bs, bp, ds = hv
    is_data = st == C.ST_DATA
    is_skurr = st == C.ST_SKURR
    is_pre = st == C.ST_PREAMBLE
    is_start = st == C.ST_STARTSIGN
    is_stop = st == C.ST_STOPSIGN
    b1 = b == 1
    b0 = ~b1
    alt = b != last

    # ST_DATA
    d_stuffed = bs == 1
    d_to_stop = d_stuffed & b1
    d_app = ~d_stuffed
    ae_new = torch.where(b1 & (last == 1), ae + 1, 0)
    d_set_stuff = ae_new == 4
    ae_app = torch.where(d_set_stuff, 0, ae_new)
    bp_app = bp + 1
    d_reset = d_app & (bp_app >= C.MAX_FRAME_DATA_BITS)
    # ST_SKURR
    ap_s = torch.where(alt, ap + 1, 0)
    s_go = (ap_s > 14) & b0
    # ST_PREAMBLE
    p_ns0 = ns == 0
    p_ns5 = ns == 5
    p_alt = alt & p_ns0
    p_to_start = ~p_alt & b1 & p_ns5
    p_reset = ~p_alt & b0 & ~p_ns0
    # ST_STARTSIGN
    t_ge7 = ns >= 7
    t_to_data = t_ge7 & b0
    t_reset = t_ge7 == b1          # (ge7 & b1) | (!ge7 & b0)
    # ST_STOPSIGN
    flen = bp - C.FRAME_TAIL_BITS
    good = b0 & (flen > 0)

    hard = (is_stop | (is_data & d_reset) | (is_pre & p_reset)
            | (is_start & t_reset))
    sd = is_start & t_to_data           # START -> DATA hand-off
    da = is_data & d_app                # DATA slot that appends

    def k(v):
        return torch.full_like(st, v)

    soft_state = torch.where(
        is_data, torch.where(d_to_stop, k(C.ST_STOPSIGN), k(C.ST_DATA)),
        torch.where(is_skurr,
                    torch.where(s_go, k(C.ST_PREAMBLE), k(C.ST_SKURR)),
                    torch.where(is_pre,
                                torch.where(p_to_start, k(C.ST_STARTSIGN),
                                            k(C.ST_PREAMBLE)),
                                torch.where(t_to_data, k(C.ST_DATA),
                                            k(C.ST_STARTSIGN)))))
    n_state = torch.where(hard, C.ST_SKURR, soft_state)
    soft_ap = torch.where(
        is_skurr, torch.where(s_go, 0, ap_s),
        torch.where(is_pre,
                    torch.where(p_alt, ap + 1, torch.where(p_to_start, 0, ap)),
                    ap))
    n_ap = torch.where(hard, 0, soft_ap)
    # under soft & is_pre & b0 only the ns==0 branch survives (!ns0 is
    # p_reset, which is hard), whose value is the constant 1
    p_ns_soft = torch.where(
        p_alt, ns,
        torch.where(b1, torch.where(p_ns0, 3, torch.where(p_ns5, 6, ns + 1)),
                    1))
    soft_ns = torch.where(is_pre, p_ns_soft,
                          torch.where(is_start,
                                      torch.where(t_to_data, 1, ns + 1), ns))
    # t_reset (the only hard case in ST_STARTSIGN) sets ns = 1, not 0
    n_ns = torch.where(hard, is_start.to(_I32), soft_ns)
    n_ae = torch.where(hard | sd, 0, torch.where(da, ae_app, ae))
    n_bs = torch.where(hard, 0,
                       torch.where(is_data, (da & d_set_stuff).to(_I32), bs))
    n_bp = torch.where(hard | sd, 0, torch.where(da, bp_app, bp))
    n_ds = torch.where(sd, spos, ds)

    emit = is_stop & good
    bad = is_stop & ~good
    return ((n_state, b, n_ap, n_ns, n_ae, n_bs, n_bp, n_ds),
            da, emit, flen, bad)


def hdlc_scan_candidates(bitrows: torch.Tensor, slot_valid: torch.Tensor,
                         state: HdlcState,
                         pos_rows: Optional[torch.Tensor] = None,
                         lost2_lo: Optional[int] = None,
                         lost2_hi: Optional[int] = None
                         ) -> Tuple[HdlcState, Candidates]:
    """Run the deframer over bit slots and return the completed frames
    as chunk candidates.

    bitrows/slot_valid/pos_rows: [S, M]; invalid slots freeze the state.
    The slot axis is padded to a multiple of HDLC_CHUNK.  lost2 counts
    wrong-size stops whose position lies in [lost2_lo, lost2_hi).

    A CUDA tensor launches the deframer kernel (``fused.hdlc_fused``); a
    CPU tensor runs the plain version, ``hdlc_scan_candidates_reference``."""
    from . import fused
    if fused.on_card(bitrows):
        return fused.hdlc_fused(state, bitrows=bitrows, slot_valid=slot_valid,
                                pos_rows=pos_rows, lost2_lo=lost2_lo,
                                lost2_hi=lost2_hi)
    return hdlc_scan_candidates_reference(bitrows, slot_valid, state,
                                          pos_rows, lost2_lo, lost2_hi)


def hdlc_scan_candidates_reference(
        bitrows: torch.Tensor, slot_valid: torch.Tensor, state: HdlcState,
        pos_rows: Optional[torch.Tensor] = None,
        lost2_lo: Optional[int] = None, lost2_hi: Optional[int] = None
        ) -> Tuple[HdlcState, Candidates]:
    """The plain version of ``hdlc_scan_candidates``, on any device: a
    Python loop over the slots, one [S]-wide step each, which syncs with
    the host once a slot (``bool(emit.any())``) on a CUDA tensor."""
    lo = -2**31 if lost2_lo is None else int(lost2_lo)
    hi = 2**31 - 1 if lost2_hi is None else int(lost2_hi)
    if pos_rows is None:
        pos_rows = torch.zeros_like(bitrows)
    s, m = bitrows.shape
    dev = bitrows.device
    if m % HDLC_CHUNK:
        pad = HDLC_CHUNK - m % HDLC_CHUNK
        bitrows = torch.nn.functional.pad(bitrows, (0, pad))
        slot_valid = torch.nn.functional.pad(slot_valid, (0, pad))
        pos_rows = torch.nn.functional.pad(pos_rows, (0, pad))
        m += pad
    n_chunks = m // HDLC_CHUNK

    any_valid = slot_valid.any(dim=0).tolist()
    all_valid = slot_valid.all(dim=0).tolist()
    b_cols = bitrows.t().contiguous().unbind(0)
    v_cols = slot_valid.t().contiguous().unbind(0)
    p_cols = pos_rows.t().contiguous().unbind(0)

    hv = tuple(state[:8])
    reg = state.shiftreg
    no = torch.zeros((s,), dtype=torch.bool, device=dev)
    emits: List[torch.Tensor] = []
    bads: List[torch.Tensor] = []
    # (slot, register before the slot, payload length, data start) for
    # every slot in which some stream completes a frame
    snaps = []
    for j in range(m):
        if not any_valid[j]:
            emits.append(no)
            bads.append(no)
            continue
        b = b_cols[j]
        hv2, append, emit, flen, bad = _hdlc_slot(hv, b, p_cols[j])
        if not all_valid[j]:
            v = v_cols[j]
            hv2 = tuple(torch.where(v, n, o) for n, o in zip(hv2, hv))
            append = append & v
            emit = emit & v
            bad = bad & v
        if bool(emit.any()):
            snaps.append((j, reg, flen, hv[7]))
        reg = torch.where(append[:, None], _reg_append(reg, b), reg)
        hv = hv2
        emits.append(emit)
        bads.append(bad)

    emit_all = torch.stack(emits, dim=1)                       # [S, M]
    bad_all = torch.stack(bads, dim=1)
    rank = (emit_all.reshape(s, n_chunks, HDLC_CHUNK).to(_I32)
            .cumsum(dim=2).reshape(s, m) - 1)
    cand = emit_all & (rank < MINI_SLOTS)
    over = (emit_all & (rank >= MINI_SLOTS)).sum(dim=1).to(_I32)
    lost2 = (bad_all & (pos_rows >= lo) & (pos_rows < hi)).sum(dim=1).to(_I32)

    kk = n_chunks * MINI_SLOTS
    cw = torch.zeros((s, kk + 1, REG_WORDS), dtype=_I32, device=dev)
    cl = torch.zeros((s, kk + 1), dtype=_I32, device=dev)
    cs = torch.zeros_like(cl)
    ce = torch.zeros_like(cl)
    cv = torch.zeros((s, kk + 1), dtype=torch.bool, device=dev)
    if snaps:
        steps = torch.tensor([j for j, *_ in snaps], device=dev)
        # candidate index = chunk * MINI_SLOTS + rank; others land in
        # the dummy column kk, which is dropped
        dst = torch.where(cand[:, steps],
                          (steps // HDLC_CHUNK) * MINI_SLOTS + rank[:, steps],
                          kk)                                  # [S, R]
        regs = torch.stack([r for _, r, _, _ in snaps], dim=1)  # [S, R, W]
        cw.scatter_(1, dst[:, :, None].expand(-1, -1, REG_WORDS), regs)
        cl.scatter_(1, dst, torch.stack([f for *_, f, _ in snaps], dim=1))
        cs.scatter_(1, dst, torch.stack([d for *_, d in snaps], dim=1))
        ce.scatter_(1, dst, pos_rows[:, steps])
        cv.scatter_(1, dst, cand[:, steps])
    new_state = HdlcState(*hv, shiftreg=reg)
    return new_state, Candidates(cv[:, :kk], cw[:, :kk], cl[:, :kk],
                                 cs[:, :kk], ce[:, :kk], lost2, over)


def hdlc_scan(bitrows: torch.Tensor, slot_valid: torch.Tensor,
              state: HdlcState, frames: FrameBatch,
              pos_rows: Optional[torch.Tensor] = None,
              lost2_lo: Optional[int] = None,
              lost2_hi: Optional[int] = None
              ) -> Tuple[HdlcState, FrameBatch]:
    """Run the deframer over dense bit slots and compact the completed
    frames into ``frames``' slots in arrival order."""
    state, c = hdlc_scan_candidates(bitrows, slot_valid, state, pos_rows,
                                    lost2_lo, lost2_hi)
    return state, compact_candidates(frames, c.valid, c.words, c.length,
                                     c.start, c.end, lost2=c.lost2,
                                     over=c.over)


def compact_candidates(frames: FrameBatch, cand_valid: torch.Tensor,
                       cw: torch.Tensor, cl: torch.Tensor, cs: torch.Tensor,
                       ce: torch.Tensor, lost2: torch.Tensor,
                       over: torch.Tensor) -> FrameBatch:
    """Move frame candidates (arrival order along axis 1) into dense
    FrameBatch slots after ``frames.count``: a cumsum gives each
    candidate its slot and one scatter lands it.  Candidates past the
    last slot count as dropped.  cand_valid [S, K] bool; cw [S, K,
    REG_WORDS]; cl/cs/ce [S, K]; lost2/over [S] counters to add."""
    s, k = cand_valid.shape
    f = frames.words.shape[1]
    dst = cand_valid.to(_I32).cumsum(dim=1) - 1 + frames.count[:, None]
    overflow = cand_valid & (dst >= f)
    keep = cand_valid & ~overflow
    idx = torch.where(keep, dst, f)            # slot f is a dummy column

    def land(base, vals):
        ext = torch.cat([base, torch.zeros_like(base[:, :1])], dim=1)
        ix = idx if vals.dim() == 2 else idx[:, :, None].expand_as(vals)
        return ext.scatter(1, ix, vals)[:, :f]

    n_new = cand_valid.sum(dim=1).to(_I32)
    n_over = overflow.sum(dim=1).to(_I32) + over
    return FrameBatch(
        words=land(frames.words, cw),
        length=land(frames.length, cl),
        start=land(frames.start, cs),
        end=land(frames.end, ce),
        count=torch.clamp(frames.count + n_new, max=f),
        lost2=frames.lost2 + lost2,
        dropped=frames.dropped + n_over,
        crcfail=frames.crcfail,
    )


class DenseFrames(NamedTuple):
    """Cross-stream dense frame buffer: only the frames that exist travel
    back to the host (a FrameBatch reads back S*frame_slots slots,
    occupied or not)."""
    words: torch.Tensor     # [CAP, REG_WORDS] int32 (uint32 bits)
    length: torch.Tensor    # [CAP] int32
    start: torch.Tensor     # [CAP] int32
    end: torch.Tensor       # [CAP] int32 stop-flag (emission) position
    stream: torch.Tensor    # [CAP] int32 source stream id (-1: empty)
    total: torch.Tensor     # scalar int32 frames present (<= CAP)
    over: torch.Tensor      # scalar int32 frames dropped (total beyond CAP)


def dense_frames(frames: FrameBatch, cap: int) -> DenseFrames:
    """Compact a FrameBatch's occupied slots (stream-major arrival order)
    into one dense [cap] buffer on the device.

    A stable argsort of the "absent" mask puts the present slots first in
    their flat order, so output j is the j-th frame overall; the gather
    that follows touches only ``cap`` rows."""
    s, f = frames.length.shape
    dev = frames.length.device
    present = (torch.arange(f, device=dev)[None, :]
               < frames.count[:, None]).reshape(-1)
    perm = torch.argsort((~present).to(torch.uint8), stable=True)[:cap]
    ok = present[perm]                                  # [cap]
    w = torch.where(ok[:, None], frames.words.reshape(s * f, -1)[perm], 0)
    ln = torch.where(ok, frames.length.reshape(-1)[perm], 0)
    st = torch.where(ok, frames.start.reshape(-1)[perm], 0)
    en = torch.where(ok, frames.end.reshape(-1)[perm], 0)
    sid = torch.where(ok, perm // f, -1).to(_I32)
    total = frames.count.sum().to(_I32)
    return DenseFrames(words=w, length=ln, start=st, end=en, stream=sid,
                       total=torch.clamp(total, max=cap),
                       over=torch.clamp(total - cap, min=0))
