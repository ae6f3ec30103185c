"""Ops of the PyTorch port against their ``gnuais_tpu`` counterparts on
the same numpy inputs, bitwise (tolerance 0: the exact chain is
bit-exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu import constants as C
from gnuais_tpu.golden.model import GoldenFir
from gnuais_tpu.ops import crc as jcrc
from gnuais_tpu.ops import demod as jdemod
from gnuais_tpu.ops import fir as jfir
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.ops import crc as tcrc
from gnuais_tpu_torch.ops import demod as tdemod
from gnuais_tpu_torch.ops import fir as tfir

T = 4096


def _np(x):
    """numpy array of a port tensor (``_eq`` reads int32 words as
    uint32 where the JAX side has uint32)."""
    return x.detach().cpu().numpy()


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _history(s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, (s, C.FIR_LEN)).astype(np.float32)


@pytest.mark.parametrize("nv", [T, T - 333, 20, 0])
def test_fir_exact_matches_jax(nv):
    x = captures.mixed(12, T, seed=1)
    h = _history(12, 2)
    jo, jh = jfir.fir_exact(jnp.asarray(x), jnp.asarray(h),
                            n_valid=jnp.int32(nv))
    to, th = tfir.fir_exact(torch.from_numpy(x), torch.from_numpy(h),
                            n_valid=nv)
    _eq(jo, _np(to), "filtered")
    _eq(jh, _np(th), "history")


def test_block_peak_matches_jax():
    x = captures.mixed(8, T, seed=3)
    x[3] = -np.abs(x[3])                      # all-negative row -> 0
    _eq(jfir.block_peak(jnp.asarray(x)), _np(tfir.block_peak(torch.from_numpy(x))))


def test_fir_keeps_subnormals_like_the_golden_model():
    """At a stream start (zero history) the first sample reaches the
    subnormal tap 33 alone: the port keeps the subnormal product, as the
    reference C receiver and the golden model do."""
    x = captures.noisy_frames(1, 512, seed=4)
    x[0, 0] = 1234
    g = GoldenFir()
    ref = g.run(x[0])
    out, hist = tfir.fir_exact(torch.from_numpy(x),
                               tfir.init_history(1, "cpu"))
    _eq(ref, _np(out)[0], "filtered")
    assert 0 < _np(out)[0, 3] < np.finfo(np.float32).tiny
    _eq(g.history, _np(hist)[0], "history")


def _filtered(s, seed):
    x = captures.mixed(s, T, seed=seed)
    out, _ = jfir.fir_exact(jnp.asarray(x), jnp.zeros((s, C.FIR_LEN),
                                                      jnp.float32))
    return np.array(out)


def _dpll_state(s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 0x10000, s).astype(np.int32),
            rng.integers(0, 2, s).astype(np.int32),
            rng.integers(0, 2, s).astype(np.int32))


@pytest.mark.parametrize("nv", [T, T - 333, 1])
def test_dpll_scan_matches_jax(nv):
    s = 12
    f = _filtered(s, 5)
    st = _dpll_state(s, 6)
    jv, jb, js = jdemod.dpll_scan(jnp.asarray(f), jnp.arange(T) < nv,
                                  jdemod.DpllState(*map(jnp.asarray, st)))
    tv, tb, ts = tdemod.dpll_scan(torch.from_numpy(f), nv,
                                  tdemod.DpllState(*map(torch.from_numpy, st)))
    _eq(jv, _np(tv), "bit_valid")
    _eq(jb, _np(tb), "bits")
    for name, a, b in zip(js._fields, js, ts):
        _eq(a, _np(b), name)


@pytest.mark.parametrize("base", [0, 77, 2**31 - 1000])
def test_group_reduce_bits_matches_jax(base):
    s = 8
    f = _filtered(s, 7)
    st = _dpll_state(s, 8)
    jv, jb, _ = jdemod.dpll_scan(jnp.asarray(f), jnp.ones(T, bool),
                                 jdemod.DpllState(*map(jnp.asarray, st)))
    j = jdemod.group_reduce_bits(jv, jb, jnp.int32(base))
    t = tdemod.group_reduce_bits(torch.from_numpy(np.array(jv)),
                                 torch.from_numpy(np.array(jb)), base)
    for name, a, b in zip(("gbits", "gvalid", "gpos"), j, t):
        _eq(a, _np(b), name)


def _slots(x, nv, base, carry=None):
    """Bit slots of the JAX chain for x, and the carry after it."""
    s = x.shape[0]
    c = jpipe.init_carry(s) if carry is None else carry
    f, _ = jfir.fir_exact(jnp.asarray(x), c.history, n_valid=jnp.int32(nv))
    bv, b, _ = jdemod.dpll_scan(f, jnp.arange(x.shape[1]) < nv, c.dpll)
    return [np.array(a) for a in jdemod.group_reduce_bits(bv, b, jnp.int32(base))]


@pytest.mark.parametrize("frame_slots,m,window", [
    (16, T // 4, None),
    (3, T // 4, None),                 # slot overflow -> dropped
    (8, 1000, (1000 + 2600, 1000 + 3600)),   # M % 64 != 0, lost2 window
])
def test_hdlc_scan_matches_jax(frame_slots, m, window):
    s = 16
    x0 = captures.mixed(s, T, seed=9)
    x1 = captures.mixed(s, T, seed=2)
    # a non-trivial starting state: the carry after one earlier block
    jc, _, _ = jpipe.decode_block(jnp.asarray(x0), jnp.int32(T - 1000),
                                  jpipe.init_carry(s), frame_slots=16)
    gb, gv, gp = (a[:, :m] for a in _slots(x1, T, 1000))
    lo, hi = window if window else (None, None)
    jkw = {} if window is None else dict(lost2_lo=jnp.int32(lo),
                                         lost2_hi=jnp.int32(hi))
    js, jf = jdemod.hdlc_scan(jnp.asarray(gb), jnp.asarray(gv), jc.hdlc,
                              jdemod.init_frames(s, frame_slots),
                              jnp.asarray(gp), **jkw)
    th = convert.carry_from_numpy([np.asarray(a) for a in jax.tree.leaves(jc)],
                                  "cpu").hdlc
    ts, tf = tdemod.hdlc_scan(torch.from_numpy(gb), torch.from_numpy(gv), th,
                              tdemod.init_frames(s, frame_slots, "cpu"),
                              torch.from_numpy(gp), lost2_lo=lo, lost2_hi=hi)
    for name, a, b in zip(js._fields, js, ts):
        _eq(a, _np(b), name)
    for name, a, b in zip(jf._fields, jf, tf):
        _eq(a, _np(b), name)
    assert np.asarray(jf.count).sum() > 0
    if frame_slots == 3:
        assert np.asarray(jf.dropped).sum() > 0
    if window:
        lost2 = np.asarray(jf.lost2)
        assert 0 < lost2.sum() < s


def test_reg_append_matches_jax():
    rng = np.random.default_rng(10)
    reg = rng.integers(0, 2**32, (64, tdemod.REG_WORDS), dtype=np.uint64) \
        .astype(np.uint32)
    bit = rng.integers(0, 2, 64).astype(np.int32)
    j = jdemod._reg_append(jnp.asarray(reg), jnp.asarray(bit))
    t = tdemod._reg_append(torch.from_numpy(reg.view(np.int32)),
                           torch.from_numpy(bit))
    _eq(j, _np(t))


def test_compact_candidates_matches_jax():
    rng = np.random.default_rng(11)
    s, k, f = 9, 24, 5
    valid = rng.random((s, k)) < 0.3
    cw = rng.integers(0, 2**32, (s, k, tdemod.REG_WORDS),
                      dtype=np.uint64).astype(np.uint32)
    # lengths stay below 2^16, as the JAX compaction's 2-byte field
    # assumes; start/end span the whole int32 range
    cl = rng.integers(0, C.MAX_FRAME_DATA_BITS, (s, k)).astype(np.int32)
    cs, ce = (rng.integers(-2**31, 2**31 - 1, (s, k)).astype(np.int32)
              for _ in range(2))
    lost2, over = (rng.integers(0, 3, s).astype(np.int32) for _ in range(2))
    base = jdemod.init_frames(s, f)
    base = base._replace(
        count=jnp.asarray(rng.integers(0, f + 1, s).astype(np.int32)),
        words=jnp.asarray(rng.integers(0, 2**32, (s, f, tdemod.REG_WORDS),
                                       dtype=np.uint64).astype(np.uint32)),
        length=jnp.asarray(rng.integers(0, 400, (s, f)).astype(np.int32)))
    j = jdemod.compact_candidates(base, jnp.asarray(valid), jnp.asarray(cw),
                                  jnp.asarray(cl), jnp.asarray(cs),
                                  jnp.asarray(ce), jnp.asarray(lost2),
                                  jnp.asarray(over))
    tb = tdemod.FrameBatch(*(torch.from_numpy(np.array(a).view(np.int32)
                                               if a.dtype == jnp.uint32
                                               else np.array(a))
                             for a in base))
    t = tdemod.compact_candidates(
        tb, torch.from_numpy(valid), torch.from_numpy(cw.view(np.int32)),
        *map(torch.from_numpy, (cl, cs, ce, lost2, over)))
    for name, a, b in zip(j._fields, j, t):
        _eq(a, _np(b), name)
    assert np.asarray(j.dropped).sum() > np.asarray(over).sum()


def test_crc_linear_accepts_and_rejects_as_jax():
    """Frames from a real decode (one of them a CRC reject), each also
    with one flipped bit among its CRC-covered bits (FCS and payload,
    register positions 6..) and one flipped bit outside the frame: the
    port accepts and rejects exactly as the JAX check and the byte-table
    check do."""
    s = 16
    x = captures.mixed(s, T, seed=12)
    _, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(T),
                                  jpipe.init_carry(s), frame_slots=16)
    cnt = np.asarray(jf.count)
    words = np.concatenate([np.asarray(jf.words)[i, :cnt[i]] for i in range(s)])
    length = np.concatenate([np.asarray(jf.length)[i, :cnt[i]] for i in range(s)])
    rng = np.random.default_rng(13)
    rows, lens = [words], [length]
    for flip_inside in (True, False):
        w = words.copy()
        for r in range(len(w)):
            nbits = int(length[r]) + C.FRAME_TAIL_BITS
            p = (int(rng.integers(6, nbits)) if flip_inside
                 else int(rng.integers(nbits, tdemod.REG_BITS)))
            w[r, tdemod.REG_WORDS - 1 - p // 32] ^= np.uint32(1 << (p % 32))
        rows.append(w)
        lens.append(length)
    # empty slots and short lengths
    rows.append(np.zeros((4, tdemod.REG_WORDS), np.uint32))
    lens.append(np.array([0, -3, 5, 9], np.int32))
    words, length = np.concatenate(rows), np.concatenate(lens)
    j = np.asarray(jcrc.crc_check_frames_linear(jnp.asarray(words),
                                                jnp.asarray(length)))
    t = _np(tcrc.crc_check_frames_linear(torch.from_numpy(words.view(np.int32)),
                                         torch.from_numpy(length)))
    _eq(j, t)
    _eq(np.asarray(jcrc.crc_check_frames(jnp.asarray(words),
                                         jnp.asarray(length))), t)
    n = len(rows[0])
    ok = t[:n]
    assert ok.sum() > 0 and (~ok).sum() > 0
    assert not t[n:2 * n][ok].any()          # a flipped covered bit rejects
    _eq(ok, t[2 * n:3 * n])                  # a bit outside changes nothing
