"""Kernels B3 (``frontend_fused``) and B4 (``dpll_fused``) of the port on
CPU tensors (their plain versions) against the JAX package's Pallas
functions in interpret mode, as its own tests run them on the CPU, and
the ``fast_dpll`` and ``fused_frontend`` branches of ``decode_block``
against JAX's.  Bitwise (tolerance 0).

The JAX functions are wrapped in ``jax.jit`` here so that the cases of
one shape share one compile of the interpreted kernel."""

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
from gnuais_tpu_torch.ops import fir as tfir
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe

S, T = 8, 1024
_jdpll = jax.jit(jfused.dpll_fused)
_jfrontend = jax.jit(jfused.frontend_fused)


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _eq_dpll(jstate, tstate):
    for name, a, b in zip(tstate._fields, jstate, tstate):
        _eq(a, b.numpy(), name)


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("nv", [2048, 700])
def test_dpll_fused_matches_jax(nv):
    """The same float32 input (the exact FIR of encoder captures) through
    JAX's kernel and the port's plain version: the raw bits agree too,
    not only where a bit was emitted."""
    x = torch.from_numpy(captures.mixed(S, 2048, seed=nv))
    filtered, _ = tfir.fir_exact(x, tfir.init_history(S, "cpu"))
    tfused.dpll_fused.launches = 0
    jv, jb, js = _jdpll(jnp.asarray(filtered.numpy()), jnp.int32(nv),
                        jdemod.init_dpll(S))
    tv, tb, ts = tfused.dpll_fused(filtered, nv, tdemod.init_dpll(S, "cpu"))
    _eq(jv, tv.numpy(), "bit_valid")
    _eq(jb, tb.numpy(), "bits")
    _eq_dpll(js, ts)
    assert int(np.asarray(jv).sum()) > nv // 6
    assert tfused.dpll_fused.launches == 0


def _frontend_pair(x, nv, hist, jstate, tstate, base):
    j = _jfrontend(jnp.asarray(x), jnp.int32(nv), jnp.asarray(hist.numpy()),
                   jstate, jnp.int32(_wrap32(base)))
    t = tfused.frontend_fused(torch.from_numpy(x), nv, hist, tstate, base)
    for name, a, b in zip(("gbits", "gvalid", "gpos", "history"), j[:4], t[:4]):
        _eq(a, b.numpy(), name)
    _eq_dpll(j[4], t[4])
    return j, t


@pytest.mark.parametrize("nv,base,hist", [
    (T, 0, 0.0), (700, 5, 0.0), (0, 77, 7.0), (1, 77, 7.0), (35, 77, 7.0)],
    ids=["full", "n_valid_700", "history_nv0", "history_nv1", "history_nv35"])
def test_frontend_fused_matches_jax(nv, base, hist):
    """Full and short blocks, and the history carry of blocks shorter
    than the FIR with a nonzero history (it must splice the history and
    the valid samples, never the padding)."""
    x = captures.noisy_frames(S, T, seed=nv)
    h = tfir.init_history(S, "cpu") + hist
    tfused.frontend_fused.launches = 0
    j, _ = _frontend_pair(x, nv, h, jdemod.init_dpll(S),
                          tdemod.init_dpll(S, "cpu"), base)
    assert tfused.frontend_fused.launches == 0
    if nv == T:
        assert int(np.asarray(j[1]).sum()) > T // 24


def test_frontend_fused_chained_blocks_match_jax():
    """Three blocks chained through each side's own history and DPLL
    state, the last one short, with block bases that cross the int32
    wrap: gpos wraps alike on both sides."""
    x = captures.mixed(S, 3 * T, seed=3)
    base0 = 2**31 - T - 300
    jh, js = tfir.init_history(S, "cpu"), jdemod.init_dpll(S)
    th, ts = jh, tdemod.init_dpll(S, "cpu")
    for b in range(3):
        nv = T if b < 2 else 700
        j, t = _frontend_pair(np.ascontiguousarray(x[:, b * T:(b + 1) * T]),
                              nv, th, js, ts, base0 + b * T)
        js, th, ts = j[4], t[3], t[4]
    assert (np.asarray(j[2]) < 0).any()


@pytest.mark.parametrize("flag", ["fast_dpll", "fused_frontend"])
def test_decode_block_kernel_branch_matches_jax(flag):
    """decode_block over three chained blocks with a short tail and a
    block base: every carry leaf and FrameBatch leaf equals JAX's
    decode_block with the same flag after every block (512-sample
    blocks, so that frames straddle the seams)."""
    t = 512
    x = captures.mixed(S, 3 * t, seed=11)
    jc, tc = jpipe.init_carry(S), tpipe.init_carry(S, "cpu")
    total = 0
    for b in range(3):
        xb = x[:, b * t:(b + 1) * t]
        nv = t if b < 2 else 300
        jc, jf, jp = jpipe.decode_block(jnp.asarray(xb), jnp.int32(nv), jc,
                                        frame_slots=8, block_base=5 + b * t,
                                        **{flag: True})
        tc, tf, tp = tpipe.decode_block(torch.from_numpy(xb), nv, tc,
                                        frame_slots=8, block_base=5 + b * t,
                                        **{flag: True})
        for i, (a, c) in enumerate(zip([np.asarray(v) for v in
                                        jax.tree.leaves(jc)],
                                       convert.carry_to_numpy(tc))):
            _eq(a, c, f"block {b} carry leaf {i}")
        for name, a, c in zip(jf._fields, jf, convert.frames_to_numpy(tf)):
            _eq(a, c, f"block {b} {name}")
        _eq(jp, tp.numpy(), "peak")
        total += int(np.asarray(jf.count).sum())
    assert total > 0


@pytest.fixture
def card_routes(monkeypatch):
    """The kernels' host build on the routes that CUDA tensors take:
    ``fused.on_card`` true for CPU tensors, launches through
    ``hostbuild.launch``, and every plain version those routes must not
    reach made to raise (the per-sample DPLL loop, the per-slot deframer
    loop, the group reduce's passes over [S, T], the wrappers' plain
    versions)."""
    from gnuais_tpu_torch import hostbuild
    if hostbuild.gxx_path() is None:
        pytest.skip("needs g++")
    hostbuild.library()
    monkeypatch.setattr(tfused, "_launch", hostbuild.launch)
    monkeypatch.setattr(tfused, "on_card", lambda x: True)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a card route")
    for mod, name in ((tdemod, "dpll_scan"),
                      (tdemod, "hdlc_scan_candidates_reference"),
                      (tdemod, "group_reduce_bits"),
                      (tfused, "frontend_fused_reference"),
                      (tfused, "dpll_fused_reference"),
                      (tfused, "hdlc_fused_reference")):
        monkeypatch.setattr(mod, name, plain)


@pytest.mark.parametrize("flag", ["fast_dpll", "fused_frontend", "exact"])
def test_decode_block_card_route_matches_jax(card_routes, flag):
    """The routes of decode_block on the card (B3, or the exact FIR and
    B4, then the deframer kernel and the candidate compaction, run here
    by the kernels' host build) against JAX's decode_block with the same
    flag (``exact``: none, JAX's exact chain) over three chained
    512-sample blocks with a short tail, a block base and a lost2
    window: every carry leaf and FrameBatch leaf equal after every
    block, and the kernels launched once each a block."""
    t = 512
    x = captures.mixed(S, 3 * t, seed=11)
    jc, tc = jpipe.init_carry(S), tpipe.init_carry(S, "cpu")
    flags = {} if flag == "exact" else {flag: True}
    launches = (tfused.frontend_fused if flag == "fused_frontend"
                else tfused.dpll_fused)
    before = (launches.launches, tfused.hdlc_fused.launches)
    total = 0
    for b in range(3):
        xb = x[:, b * t:(b + 1) * t]
        nv = t if b < 2 else 300
        kw = dict(frame_slots=8, block_base=5 + b * t, **flags)
        jc, jf, jp = jpipe.decode_block(
            jnp.asarray(xb), jnp.int32(nv), jc, lost2_lo=jnp.int32(100),
            lost2_hi=jnp.int32(1200), **kw)
        tc, tf, tp = tpipe.decode_block(torch.from_numpy(xb), nv, tc,
                                        lost2_lo=100, lost2_hi=1200, **kw)
        for i, (a, c) in enumerate(zip([np.asarray(v) for v in
                                        jax.tree.leaves(jc)],
                                       convert.carry_to_numpy(tc))):
            _eq(a, c, f"block {b} carry leaf {i}")
        for name, a, c in zip(jf._fields, jf, convert.frames_to_numpy(tf)):
            _eq(a, c, f"block {b} {name}")
        _eq(jp, tp.numpy(), "peak")
        total += int(np.asarray(jf.count).sum())
    assert total > 0
    assert (launches.launches, tfused.hdlc_fused.launches) == \
        (before[0] + 3, before[1] + 3)
