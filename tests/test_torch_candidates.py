"""Kernel B2 (``pipeline_fused``: frame candidates) and the fused branch
of ``decode_block`` that runs it, on CPU tensors (the plain version),
against the JAX package: the Pallas kernel in interpret mode, as the JAX
package's own tests run it, and the exact chain.  Bitwise (tolerance 0).
Empty candidate slots are compared only through ``cand_valid``: what
they hold is not part of the contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu.ops import demod as jdemod
from gnuais_tpu.ops import fused as jfused
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.ops import demod as tdemod
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe

from test_torch_fused import CASES, _eq, _same_step

# (n_valid, lost2_lo, lost2_hi) for the T = 2560 block of the interpret
# tests: full, a short tail, a lost2 window
BOUNDS = ((2560, -2**31, 2**31 - 1), (2560 - 700, -2**31, 2**31 - 1),
          (2560, 500, 2000))


def _capture():
    x = captures.wrong_size_and_crc(4, 2560, seed=3)
    x[1, 900:905] = -x[1, 900:905]
    return x


def _same_candidates(jout, tout, what=""):
    """Candidates equal where valid; validity, counters and carry
    bitwise."""
    j = [np.asarray(v) for v in jout[:7]]
    t = convert.candidates_to_numpy(tout)
    _eq(j[0], t[0], f"{what} cand_valid")
    valid = j[0]
    for i, name in ((1, "cw"), (2, "cl"), (3, "cs"), (4, "ce")):
        assert j[i].dtype == t[i].dtype and j[i].shape == t[i].shape, name
        _eq(j[i][valid], t[i][valid], f"{what} {name}")
    _eq(j[5], t[5], f"{what} lost2")
    _eq(j[6], t[6], f"{what} over")
    jc = [np.asarray(v) for v in jax.tree.leaves(jout[7:])]
    tc = convert.carry_to_numpy(tpipe.PipelineCarry(*tout[7:]))
    for i, (a, b) in enumerate(zip(jc, tc)):
        _eq(a, b, f"{what} carry leaf {i}")
    return int(valid.sum())


def test_b2_plain_matches_jax_kernel_interpret():
    """JAX's pipeline_fused (the Pallas kernel B2 in interpret mode, one
    compile: the bounds ride as dynamic scalars) against the port's on
    CPU tensors, which runs the plain version and launches nothing."""
    x = _capture()
    s = x.shape[0]
    jc = jpipe.init_carry(s)
    step = jax.jit(lambda xx, nv, lo, hi: jfused.pipeline_fused(
        xx, nv, jc.history, jc.dpll, jc.hdlc, block_base=77,
        lost2_lo=lo, lost2_hi=hi))
    tfused.pipeline_fused.launches = 0
    n = []
    for nv, lo, hi in BOUNDS:
        jout = step(jnp.asarray(x), jnp.int32(nv), jnp.int32(lo),
                    jnp.int32(hi))
        tc = tpipe.init_carry(s, "cpu")
        tout = tfused.pipeline_fused(torch.from_numpy(x), nv, tc.history,
                                     tc.dpll, tc.hdlc, block_base=77,
                                     lost2_lo=lo, lost2_hi=hi)
        n.append(_same_candidates(jout, tout, f"n_valid={nv} [{lo}, {hi})"))
        assert tout[0].shape == (s, tfused.n_candidates(2560)) == (s, 20)
    assert n[0] > n[1] > 0
    assert tfused.pipeline_fused.launches == 0


def test_fused_decode_block_matches_jax_b2_branch():
    """JAX's decode_block(fused_pipeline=True, device_crc=True), whose
    kernel_compact default takes the B2 branch (interpret mode), against
    the port's decode_block with the same flags, which takes B2's plain
    version and compact_candidates: FrameBatch, carry and peak."""
    x = _capture()
    s = x.shape[0]
    tfused.pipeline_fused.launches = 0
    tfused.pipeline_fused_compact.launches = 0
    crcfail = 0
    for nv, lo, hi in BOUNDS:
        jc, jf, jp = jpipe.decode_block(
            jnp.asarray(x), jnp.int32(nv), jpipe.init_carry(s), frame_slots=8,
            fused_pipeline=True, device_crc=True, lost2_lo=jnp.int32(lo),
            lost2_hi=jnp.int32(hi))
        tc, tf, tp = tpipe.decode_block(
            torch.from_numpy(x), nv, tpipe.init_carry(s, "cpu"),
            frame_slots=8, fused_pipeline=True, device_crc=True,
            lost2_lo=lo, lost2_hi=hi)
        _same_step(jc, jf, tc, tf)
        _eq(jp, tp.numpy(), "peak")
        crcfail += int(np.asarray(jf.crcfail).sum())
    assert crcfail >= 2
    assert tfused.pipeline_fused.launches == 0
    assert tfused.pipeline_fused_compact.launches == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_b2_plain_matches_jax_exact_chain(case):
    """The port's B2 branch (candidates, then compact_candidates) equals
    the JAX exact chain's FrameBatch and carry."""
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


@pytest.mark.parametrize("case", ["mixed_tail", "overflow", "lost2_window"])
def test_compacted_candidates_equal_b1(case):
    """compact_candidates over B2's candidates gives B1's dense slots,
    count, lost2, over and carry, bit for bit."""
    build, s, t, nv, fs, base, window = CASES[case]
    x = torch.from_numpy(build(s, t, seed=len(case)))
    lo, hi = window or (None, None)
    c = tpipe.init_carry(s, "cpu")
    kw = dict(block_base=base, lost2_lo=lo, lost2_hi=hi)
    b2 = tfused.pipeline_fused(x, nv, c.history, c.dpll, c.hdlc, **kw)
    b1 = tfused.pipeline_fused_compact(x, nv, c.history, c.dpll, c.hdlc,
                                       frame_slots=fs, **kw)
    dense = tdemod.compact_candidates(tdemod.init_frames(s, fs, "cpu"),
                                      *b2[:5], lost2=b2[5], over=b2[6])
    assert torch.equal(b2[0].sum(dim=1).to(torch.int32), b1[0])
    assert torch.equal(dense.count, b1[0].clamp(max=fs))
    for a, b in zip((dense.words, dense.length, dense.start, dense.end,
                     dense.lost2), b1[1:6]):
        assert torch.equal(a, b)
    assert torch.equal(dense.dropped, b1[6] + (b1[0] - fs).clamp(min=0))
    for a, b in zip(convert.carry_to_numpy(tpipe.PipelineCarry(*b2[7:])),
                    convert.carry_to_numpy(tpipe.PipelineCarry(*b1[7:]))):
        _eq(a, b, "carry")


def test_candidate_slots_follow_the_chunks():
    """Completion n of 64-slot chunk c lands in slot 2c + n, as JAX's
    mini slots do: on minimal back-to-back frames each valid slot's end
    position lies in its chunk's 256 samples, and the slots fill from
    the even one."""
    s, t = 8, 4096
    x = torch.from_numpy(captures.minimal_frames(s, t, seed=3))
    c = tpipe.init_carry(s, "cpu")
    valid, _, _, _, end, _, over = tfused.pipeline_fused(
        x, t, c.history, c.dpll, c.hdlc)[:7]
    assert valid.shape == (s, 32) and int(valid.sum()) > 4 * s
    chunk = torch.arange(32)[None, :] // 2
    assert bool(((end // 256 == chunk) | ~valid).all())
    assert bool((valid[:, 0::2] | ~valid[:, 1::2]).all())
    assert not over.any()
    assert (tdemod.HDLC_CHUNK, tdemod.MINI_SLOTS) == (jdemod.HDLC_CHUNK,
                                                      jdemod.MINI_SLOTS)
