"""The ``mxu`` FIR mode of kernels B1 and B2 on CPU tensors (the plain
versions: ``fir.fir_mxu``, a float32 banded matrix product per 32-sample
chunk) against the JAX package's Pallas kernels in interpret mode and
against the exact chain.

Tolerance: the mode sums in another order than the exact FIR, as JAX's
does on the MXU, so it is held to packet parity, not bitwise: on
captures the frames (words, length, start, end, counts) and the carry
(DPLL, deframer, FIR history) equal the other side's; the filtered
values stay within ``fused.MXU_BOUND`` of ``fir_exact``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu import constants as C
from gnuais_tpu.ops import fused as jfused
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.ops import fir as tfir
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe

from test_torch_candidates import _same_candidates
from test_torch_fused import _eq, _same_step


@pytest.mark.parametrize("unroll", [32, 64])
def test_band_matrix_matches_jax(unroll):
    want = jfused._fir_band_matrix(unroll)
    got = tfir.band_matrix(unroll).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("t,nv", [(2048, 2048), (1000, 1000), (2048, 20)])
def test_fir_mxu_within_bound_of_exact(t, nv):
    """Every filtered value within MXU_BOUND of the exact FIR's, from a
    carried history of noise; the same history carried on."""
    s = 5
    x = captures.garbage(s, t, seed=t + nv)
    h = captures.garbage(s, C.FIR_LEN, seed=nv).astype(np.float32)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    out, hist = tfir.fir_mxu(xt, ht, n_valid=nv)
    exact, hist_x = tfir.fir_exact(xt, ht, n_valid=nv)
    assert out.shape == (s, t) and out.dtype == torch.float32
    _eq(hist_x.numpy(), hist.numpy(), "history")
    full = np.concatenate([h, x.astype(np.float32)], axis=1).astype(np.float64)
    taps = np.asarray(C.FIR_TAPS, np.float32).astype(np.float64)
    mag = sum(np.abs(full[:, i:i + t] * taps[i]) for i in range(C.FIR_LEN))
    lim = tfused.MXU_BOUND[0] * mag + tfused.MXU_BOUND[1]
    err = np.abs(out.numpy().astype(np.float64) - exact.numpy())
    assert (err <= lim).all(), float((err / lim).max())
    assert err.max() > 0          # a different summation order
    # the chunking is aligned to sample 0: the first chunk's outputs are
    # the band product over the history and the first 32 samples
    win = torch.cat([ht, xt[:, :32].to(torch.float32)], dim=1)
    np.testing.assert_array_equal(
        out[:, :32].numpy(), (win @ tfir.band_matrix(32).t()).numpy())


def test_mxu_b1_and_b2_match_jax_kernel_interpret():
    """decode_block(fused_pipeline, kernel_compact, mxu_fir) (B1) and
    pipeline_fused(fir_mode="mxu") (B2): JAX's Pallas kernels in
    interpret mode (its float32 dot on the CPU) against the port's plain
    versions on captures with noise; frames, valid candidates, the
    DPLL and deframer carry and the history equal."""
    s, t = 4, 2048
    x = captures.noisy_frames(s, t, seed=23)
    jc, jf, _ = jpipe.decode_block(
        jnp.asarray(x), jnp.int32(t), jpipe.init_carry(s), frame_slots=8,
        block_base=512, fused_pipeline=True, kernel_compact=True,
        mxu_fir=True)
    tfused.pipeline_fused_compact.launches = 0
    tc, tf, _ = tpipe.decode_block(
        torch.from_numpy(x), t, tpipe.init_carry(s, "cpu"), frame_slots=8,
        block_base=512, fused_pipeline=True, kernel_compact=True,
        mxu_fir=True)
    _same_step(jc, jf, tc, tf)
    assert int(np.asarray(jf.count).sum()) > 0
    assert tfused.pipeline_fused_compact.launches == 0

    hist = captures.garbage(s, C.FIR_LEN, seed=24).astype(np.float32)
    j0 = jpipe.init_carry(s)
    jout = jfused.pipeline_fused(jnp.asarray(x), jnp.int32(t),
                                 jnp.asarray(hist), j0.dpll, j0.hdlc,
                                 fir_mode="mxu")
    t0 = tpipe.init_carry(s, "cpu")
    tout = tfused.pipeline_fused(torch.from_numpy(x), t,
                                 torch.from_numpy(hist), t0.dpll, t0.hdlc,
                                 fir_mode="mxu")
    assert _same_candidates(jout, tout, "mxu") > 0


def test_mxu_decodes_the_same_frames_as_the_exact_chain():
    """Packet parity, 8 x 4096 with the CRC on the device: the mxu FIR
    decodes the frames of the exact chain, with the same carry, through
    B2 and through B1."""
    s, t = 8, 4096
    x = torch.from_numpy(captures.noisy_frames(s, t, seed=44))
    c0 = tpipe.init_carry(s, "cpu")
    ce, fe, _ = tpipe.decode_block(x, t, c0, frame_slots=8)
    want = convert.frames_to_numpy(tpipe._device_crc_filter(fe, s, 8))
    for compact in (False, True):
        cm, fm, _ = tpipe.decode_block(x, t, c0, frame_slots=8,
                                       fused_pipeline=True, device_crc=True,
                                       mxu_fir=True, kernel_compact=compact)
        for name, a, b in zip(want._fields, want,
                              convert.frames_to_numpy(fm)):
            _eq(a, b, name)
        for i, (a, b) in enumerate(zip(convert.carry_to_numpy(ce),
                                       convert.carry_to_numpy(cm))):
            _eq(a, b, f"carry leaf {i}")
    assert want.count.sum() >= s


def test_mxu_superblock_equals_chained_blocks():
    s, t, k = 4, 1024, 3
    x = torch.from_numpy(captures.mixed(s, k * t, seed=45))
    flags = dict(frame_slots=8, fused_pipeline=True, mxu_fir=True)
    cs, fs, _ = tpipe.decode_superblock(x, k * t - 100,
                                        tpipe.init_carry(s, "cpu"), k,
                                        block_base=7, **flags)
    c = tpipe.init_carry(s, "cpu")
    for b in range(k):
        c, f, _ = tpipe.decode_block(x[:, b * t:(b + 1) * t],
                                     min(t, k * t - 100 - b * t), c,
                                     block_base=7 + b * t, **flags)
        for name, a, w in zip(f._fields, fs, f):
            _eq(a[b].numpy(), w.numpy(), f"block {b} {name}")
    for i, (a, b) in enumerate(zip(convert.carry_to_numpy(cs),
                                   convert.carry_to_numpy(c))):
        _eq(a, b, f"carry leaf {i}")


def test_mxu_fir_requires_fused_pipeline():
    c = tpipe.init_carry(2, "cpu")
    x = torch.zeros((2, 1024), dtype=torch.int16)
    with pytest.raises(ValueError):
        tpipe.decode_block(x, 1024, c, mxu_fir=True)
    with pytest.raises(ValueError):
        tpipe.BatchPipeline(2, block_len=1024, mxu_fir=True, device="cpu")
    pipe = tpipe.BatchPipeline(2, block_len=1024, fused_pipeline=True,
                               mxu_fir=True, device="cpu")
    assert pipe.flags["mxu_fir"] is True
    with pytest.raises(ValueError):
        tfused.fir_mxu_probe(x, c.history)        # the probe is CUDA only
