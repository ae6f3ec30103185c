"""The ``lobe`` FIR mode of kernels B1 and B2 (taps 10..25, symmetric
pairs) on CPU tensors (their plain versions, ``fir.fir_lobe``) against
the JAX package's Pallas kernels in interpret mode.  The pair sums of
int16 samples are exact and every lobe tap is a normal float32, so the
two agree bit for bit (tolerance 0)."""

import jax
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


def test_lobe_b1_matches_jax_kernel_interpret():
    """decode_block(fused_pipeline, kernel_compact, lobe_fir) in both
    packages: JAX's B1 lobe kernel in interpret mode, the port's plain
    version; a short tail and a nonzero block base."""
    s, t, nv = 4, 2560, 2560 - 300
    x = captures.mixed(s, t, seed=41)
    jc, jf, _ = jpipe.decode_block(
        jnp.asarray(x), jnp.int32(nv), jpipe.init_carry(s), frame_slots=8,
        block_base=1234, fused_pipeline=True, kernel_compact=True,
        lobe_fir=True)
    tfused.pipeline_fused_compact.launches = 0
    tc, tf, _ = tpipe.decode_block(
        torch.from_numpy(x), nv, tpipe.init_carry(s, "cpu"), frame_slots=8,
        block_base=1234, fused_pipeline=True, kernel_compact=True,
        lobe_fir=True)
    _same_step(jc, jf, tc, tf)
    assert int(np.asarray(jf.count).sum()) > 0
    assert tfused.pipeline_fused_compact.launches == 0


def test_lobe_b2_matches_jax_kernel_interpret():
    """pipeline_fused(fir_mode="lobe"): JAX's B2 lobe kernel in
    interpret mode against the port's plain version, candidates and
    carry, from a carried history of noise."""
    s, t = 4, 2560
    x = captures.wrong_size_and_crc(s, t, seed=42)
    hist = captures.garbage(s, C.FIR_LEN, seed=43).astype(np.float32)
    jc = jpipe.init_carry(s)
    jout = jfused.pipeline_fused(jnp.asarray(x), jnp.int32(t),
                                 jnp.asarray(hist), jc.dpll, jc.hdlc,
                                 fir_mode="lobe")
    tc = tpipe.init_carry(s, "cpu")
    tout = tfused.pipeline_fused(torch.from_numpy(x), t,
                                 torch.from_numpy(hist), tc.dpll, tc.hdlc,
                                 fir_mode="lobe")
    assert _same_candidates(jout, tout, "lobe") > 0


@pytest.mark.parametrize("nv", [2048, 1000, 20])
def test_fir_lobe_pairs_the_main_lobe(nv):
    """fir_lobe is the pair sum over taps 10..17 in that order (a numpy
    float32 transcription), and it carries the same history as the
    exact FIR."""
    s, t = 3, 2048
    x = captures.garbage(s, t, seed=nv)
    h = captures.garbage(s, C.FIR_LEN, seed=nv + 1).astype(np.float32)
    out, hist = tfir.fir_lobe(torch.from_numpy(x), torch.from_numpy(h),
                              n_valid=nv)
    full = np.concatenate([h, x.astype(np.float32)], axis=1)
    taps = np.asarray(C.FIR_TAPS, np.float32)
    want = None
    for i in range(tfir.LOBE_LO, 18):
        term = (full[:, i:i + t] + full[:, 35 - i:35 - i + t]) * taps[i]
        want = term if want is None else want + term
    _eq(want, out.numpy(), "lobe FIR")
    _, hx = tfir.fir_exact(torch.from_numpy(x), torch.from_numpy(h),
                           n_valid=nv)
    _eq(hx.numpy(), hist.numpy(), "history")
    assert (tfir.LOBE_LO, tfir.LOBE_HI) == (jfused.LOBE_LO, jfused.LOBE_HI)


def test_lobe_decodes_the_same_frames():
    """Packet parity on a capture: the lobe FIR decodes the same frames
    as the exact chain (B2 path, dense slots compared)."""
    s, t = 8, 4096
    x = torch.from_numpy(captures.noisy_frames(s, t, seed=44))
    out = []
    for lobe in (False, True):
        _, f, _ = tpipe.decode_block(x, t, tpipe.init_carry(s, "cpu"),
                                     frame_slots=8, fused_pipeline=True,
                                     device_crc=True, lobe_fir=lobe)
        out.append(convert.frames_to_numpy(f))
    for name, a, b in zip(out[0]._fields, *out):
        _eq(a, b, name)
    assert out[0].count.sum() > 0


def test_lobe_fir_requires_fused_pipeline():
    c = tpipe.init_carry(2, "cpu")
    x = torch.zeros((2, 1024), dtype=torch.int16)
    with pytest.raises(ValueError):
        tpipe.decode_block(x, 1024, c, lobe_fir=True)
    with pytest.raises(ValueError):
        tpipe.BatchPipeline(2, block_len=1024, lobe_fir=True, device="cpu")
