"""Kernel B2's prefiltered mode (``pipeline_fused``) and the JAX kernel's
other landing on CPU tensors, the plain version, against the JAX
package's Pallas kernel in interpret mode, as its own tests run it: bitwise (tolerance 0), empty
candidate slots compared through ``cand_valid`` only
(``test_torch_candidates._same_candidates``).  And the wrapper's
refusals of what it does not take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu.ops import fir as jfir
from gnuais_tpu.ops import fused as jfused
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe

from test_torch_candidates import BOUNDS, _capture, _same_candidates


def test_prefiltered_plain_matches_jax_kernel_interpret():
    """JAX's pipeline_fused(prefiltered=True) on the block that JAX's
    fir_exact filters (one compile: the bounds ride as dynamic scalars)
    against the port's on the same float32 samples: candidates, counters
    and carry bitwise, the history passed in returned unchanged."""
    x = _capture()
    s = x.shape[0]
    jc = jpipe.init_carry(s)
    hist = captures.garbage(s, 36, seed=4).astype(np.float32)
    filtered = np.array(jfir.fir_exact(jnp.asarray(x), jnp.asarray(hist))[0])
    step = jax.jit(lambda xx, nv, lo, hi: jfused.pipeline_fused(
        xx, nv, jnp.asarray(hist), jc.dpll, jc.hdlc, block_base=77,
        lost2_lo=lo, lost2_hi=hi, prefiltered=True))
    tfused.pipeline_fused.launches = 0
    n = []
    for nv, lo, hi in BOUNDS:
        jout = step(jnp.asarray(filtered), jnp.int32(nv), jnp.int32(lo),
                    jnp.int32(hi))
        tc = tpipe.init_carry(s, "cpu")
        th = torch.from_numpy(hist)
        tout = tfused.pipeline_fused(torch.from_numpy(filtered), nv, th,
                                     tc.dpll, tc.hdlc, block_base=77,
                                     lost2_lo=lo, lost2_hi=hi,
                                     prefiltered=True)
        n.append(_same_candidates(jout, tout, f"n_valid={nv} [{lo}, {hi})"))
        assert tout[7] is th
    assert n[0] > n[1] > 0
    assert tfused.pipeline_fused.launches == 0


def test_slot_landing_plain_matches_jax_kernel_interpret():
    """JAX's landing="slot" (its default is "body", the port kernel's one
    landing) against the port, one call on the block of the interpret
    tests with a short tail and a lost2 window (JAX's unroll 8 and
    unguarded snapshots: the same results as its defaults, a sixth of
    the interpret time)."""
    x = _capture()
    s = x.shape[0]
    jc = jpipe.init_carry(s)
    nv, lo, hi = BOUNDS[1][0], BOUNDS[2][1], BOUNDS[2][2]
    step = jax.jit(lambda xx: jfused.pipeline_fused(
        xx, jnp.int32(nv), jc.history, jc.dpll, jc.hdlc, block_base=3,
        lost2_lo=jnp.int32(lo), lost2_hi=jnp.int32(hi), landing="slot",
        unroll=8, guarded=False))
    jout = step(jnp.asarray(x))
    tc = tpipe.init_carry(s, "cpu")
    tout = tfused.pipeline_fused(torch.from_numpy(x), nv, tc.history,
                                 tc.dpll, tc.hdlc, block_base=3,
                                 lost2_lo=lo, lost2_hi=hi)
    assert _same_candidates(jout, tout, "landing=slot") > 0


REFUSALS = {
    "int16_prefiltered": (torch.int16, dict(prefiltered=True), TypeError),
    "float32_raw": (torch.float32, {}, TypeError),
    "unknown_strip": (torch.int16, dict(strip="shift,nope"), ValueError),
    "strip_on_cpu": (torch.int16, dict(strip="snap"), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    """int16 samples with prefiltered, float32 without it, an unknown strip
    flag and a strip for a CPU tensor (a stripped kernel has no plain
    version) each raise before anything runs."""
    dtype, kw, exc = REFUSALS[case]
    c = tpipe.init_carry(3, "cpu")
    x = torch.zeros((3, 512), dtype=dtype)
    before = tfused.pipeline_fused.launches
    with pytest.raises(exc):
        tfused.pipeline_fused(x, 512, c.history, c.dpll, c.hdlc, **kw)
    assert tfused.pipeline_fused.launches == before
    assert tfused.strip_mask("shift,snap") == 24
