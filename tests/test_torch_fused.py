"""The port's fused decode step on CPU tensors (its plain version)
against the JAX package: against the Pallas kernel in interpret mode, as
the JAX package's own tests run it, and against the exact chain.
Bitwise (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu import constants as C
from gnuais_tpu.ops import fused as jfused
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _same_step(jc, jf, tc, tf):
    for i, (a, b) in enumerate(zip([np.asarray(v) for v in jax.tree.leaves(jc)],
                                   convert.carry_to_numpy(tc))):
        _eq(a, b, f"carry leaf {i}")
    for name, a, b in zip(jf._fields, jf, convert.frames_to_numpy(tf)):
        _eq(a, b, name)


def test_fused_plain_matches_jax_kernel_interpret():
    """JAX's decode_block(fused_pipeline, kernel_compact, device_crc)
    runs the Pallas kernel in interpret mode at the shape of its own
    tier-1 parity test; the bounds ride as dynamic scalars, so its three
    cases share one compile.  The port's fused branch on CPU tensors
    takes the plain version and never launches the kernel."""
    s, t = 4, 2560
    x = captures.noisy_frames(s, t, n_payloads=1, gap_bits=8)
    x[1, 900:905] = -x[1, 900:905]         # a CRC reject on stream 1
    tfused.pipeline_fused_compact.launches = 0
    counts = []
    for nv, lo, hi in ((t, -2**31, 2**31 - 1), (t - 700, -2**31, 2**31 - 1),
                       (t, 500, 2000)):
        jc, jf, jp = jpipe.decode_block(
            jnp.asarray(x), jnp.int32(nv), jpipe.init_carry(s), frame_slots=8,
            fused_pipeline=True, kernel_compact=True, device_crc=True,
            lost2_lo=jnp.int32(lo), lost2_hi=jnp.int32(hi))
        tc, tf, tp = tpipe.decode_block(
            torch.from_numpy(x), nv, tpipe.init_carry(s, "cpu"), frame_slots=8,
            fused_pipeline=True, device_crc=True, lost2_lo=lo, lost2_hi=hi)
        _same_step(jc, jf, tc, tf)
        _eq(jp, tp.numpy(), "peak")
        counts.append(np.asarray(jf.count))
    assert counts[0].sum() >= 3 and int(np.asarray(jf.crcfail)[1]) == 1
    assert tfused.pipeline_fused_compact.launches == 0


CASES = {
    # name: (capture function, S, T, n_valid, frame_slots, block_base, lost2 window)
    "frames": (captures.noisy_frames, 37, 4096, 4096, 8, 77, None),
    "mixed_tail": (captures.mixed, 37, 4096, 4096 - 333, 8, 0, None),
    "short_tail": (captures.mixed, 8, 4096, 20, 8, 0, None),
    "overflow": (captures.minimal_frames, 8, 4096, 4096, 3, 0, None),
    "lost2_window": (captures.wrong_size_and_crc, 16, 4096, 4096, 8, 1000,
                     (1000 + 2600, 1000 + 3600)),
    "odd_slots": (captures.mixed, 12, 4096, 4096, 24, 5, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_matches_jax_exact_chain(case):
    """The port's fused step (dense slots, count_raw, over) composed
    into a FrameBatch equals the JAX exact chain's FrameBatch and carry."""
    build, s, t, nv, fs, base, window = CASES[case]
    x = build(s, t, seed=len(case))
    lo, hi = window or (None, None)
    jkw = {} if window is None else dict(lost2_lo=jnp.int32(lo),
                                         lost2_hi=jnp.int32(hi))
    jc, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(nv),
                                   jpipe.init_carry(s), frame_slots=fs,
                                   block_base=base, **jkw)
    tc, tf, _ = tpipe.decode_block(torch.from_numpy(x), nv,
                                   tpipe.init_carry(s, "cpu"), frame_slots=fs,
                                   block_base=base, fused_pipeline=True,
                                   lost2_lo=lo, lost2_hi=hi)
    _same_step(jc, jf, tc, tf)
    if case == "overflow":
        assert np.asarray(jf.dropped).min() > 0
    if case == "lost2_window":
        assert 0 < np.asarray(jf.lost2).sum() < s


@pytest.mark.parametrize("build", [captures.minimal_frames, captures.garbage])
def test_over_is_zero_like_the_exact_chain(build):
    """``over`` (completions beyond MINI_SLOTS in one 64-slot chunk) is
    claimed structurally 0; check it on the densest legal frames and on
    garbage: the JAX exact chain drops nothing with ample slots, and the
    port reports over == 0 with the same frame count."""
    s, t = 16, 4096
    x = build(s, t, seed=21)
    _, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(t),
                                  jpipe.init_carry(s), frame_slots=64)
    c = tpipe.init_carry(s, "cpu")
    out = tfused.pipeline_fused_compact(torch.from_numpy(x), t, c.history,
                                        c.dpll, c.hdlc, frame_slots=64)
    count_raw, over = out[0].numpy(), out[6].numpy()
    assert not np.asarray(jf.dropped).any()
    assert not over.any()
    _eq(np.asarray(jf.count), count_raw)


@pytest.mark.parametrize("nv", [2560, 100, 36, 20, 0])
def test_carry_history_matches_jax(nv):
    """The kernel wrapper's history carry (clamped for n_valid < 36)
    equals JAX's _carry_history and the exact FIR's history."""
    s, t = 5, 2560
    x = captures.garbage(s, t, seed=nv)
    h = captures.garbage(s, C.FIR_LEN, seed=nv + 1).astype(np.float32)
    j = jfused._carry_history(jnp.asarray(x), jnp.asarray(h), jnp.int32(nv))
    tt = tfused._carry_history(torch.from_numpy(x), torch.from_numpy(h), nv)
    _eq(j, tt.numpy())
    from gnuais_tpu_torch.ops import fir as tfir
    _, th = tfir.fir_exact(torch.from_numpy(x), torch.from_numpy(h), n_valid=nv)
    _eq(th.numpy(), tt.numpy())


def test_device_crc_filter_matches_jax():
    """The on-device CRC post-pass over the exact chain's frames: the
    same kept frames and crcfail counts as JAX's filter."""
    s, t, fs = 16, 4096, 8
    x = captures.wrong_size_and_crc(s, t, seed=2)
    _, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(t),
                                  jpipe.init_carry(s), frame_slots=fs)
    jk = jpipe._device_crc_filter(jf, s, fs)
    _, tf, _ = tpipe.decode_block(torch.from_numpy(x), t,
                                  tpipe.init_carry(s, "cpu"), frame_slots=fs)
    tk = tpipe._device_crc_filter(tf, s, fs)
    for name, a, b in zip(jk._fields, jk, convert.frames_to_numpy(tk)):
        _eq(a, b, name)
    assert np.asarray(jk.crcfail).sum() >= s // 2


def test_fused_rejects_what_it_does_not_port():
    c = tpipe.init_carry(2, "cpu")
    x = torch.zeros((2, 1024), dtype=torch.int16)
    with pytest.raises(ValueError):
        tfused.pipeline_fused_compact(x, 1024, c.history, c.dpll, c.hdlc,
                                      fir_mode="tpu")
    with pytest.raises(ValueError):
        tfused.pipeline_fused_compact(x[:, :1022], 1022, c.history, c.dpll,
                                      c.hdlc)
    with pytest.raises(ValueError):
        tpipe.decode_block(x, 1024, c, device_crc=True)
