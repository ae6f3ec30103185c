"""The roofline tool's kernels R1 (``chain``) and R2 (``stream``) on CPU
tensors (their plain versions) against the JAX package's
``tools/roofline.py``: R1's final PLL against ``make_chain_kernel`` run
in interpret mode, R2's input against its ``build``, bit for bit; R2
against the port's own exact chain run pass by pass (JAX's R2 runs at
least 2^22 steps a call, too many for interpret mode)."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnuais_tpu_torch import captures
from gnuais_tpu_torch import roofline as R
from gnuais_tpu_torch.ops import demod, fir

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "roofline.py"


@pytest.fixture(scope="module")
def jroof():
    spec = importlib.util.spec_from_file_location("jax_roofline", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeds(n, seed=7):
    return np.random.default_rng(seed).integers(1, 2**31 - 1, n,
                                                dtype=np.int32)


@pytest.mark.parametrize("mode", R.CHAIN_MODES)
def test_chain_matches_jax_kernel_interpret(jroof, monkeypatch, mode):
    """R1 at [8, 128] lanes, 64 steps: the final PLL bit for bit, the
    JAX kernel's pallas_call run in interpret mode (this test only)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    seed = _seeds((8, 128))
    want = np.asarray(jroof.make_chain_kernel(8, 64, mode)(jnp.asarray(seed)))
    pll, hdlc = R.chain(torch.from_numpy(seed.reshape(-1)), 64, mode)
    np.testing.assert_array_equal(want.reshape(-1), pll.numpy())
    assert (pll != 0).any()
    if "hdlc" not in mode:
        for a, b in zip(hdlc, demod.init_hdlc(8 * 128, "cpu")):
            assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [1024, 40448])
def test_stream_input_matches_jax_build(jroof, steps):
    """R2's input, time-major, equals JAX's tiles; past 32,768 steps the
    step index wraps as int16 in both."""
    seed = _seeds((8, 128), seed=steps)
    _, build = jroof.make_chain_kernel(8, steps, "stream+dpll")
    want = np.asarray(build(jnp.asarray(seed)))
    got = R.build_input(torch.from_numpy(seed.reshape(-1)), steps)
    np.testing.assert_array_equal(want.reshape(steps, -1), got.numpy())


def _chain_by_pass(x, passes, with_fir):
    """The exact chain over ``passes`` repeats of the time-major input,
    one pass at a time with the carry handed on: the FIR history, the
    DPLL state and the deframer state (``demod.hdlc_scan``)."""
    steps, s = x.shape
    rows = x.t().contiguous()
    hist = fir.init_history(s, "cpu")
    dpll = demod.init_dpll(s, "cpu")
    hdlc = demod.init_hdlc(s, "cpu")
    pos = ((4 * torch.arange(steps // 4) + 3) % R.TIME_CHUNK).to(torch.int32)
    for _ in range(passes):
        if with_fir:
            filtered, hist = fir.fir_lobe(rows, hist)
        else:
            filtered = rows.to(torch.float32)
        emit, bits, dpll = demod.dpll_scan(filtered, steps, dpll)
        gbits, gvalid, _ = demod.group_reduce_bits(emit, bits)
        hdlc, _ = demod.hdlc_scan(gbits, gvalid, hdlc,
                                  demod.init_frames(s, 4, "cpu"),
                                  pos[None, :].expand(s, -1))
    return dpll.pll, hdlc


def test_stream_dpll_equals_the_chain():
    seed = torch.from_numpy(_seeds(48))
    x = R.build_input(seed, 1024)
    pll, hdlc, dummy = R.stream(x, "stream+dpll", 3)
    want, _ = _chain_by_pass(x, 3, with_fir=False)
    assert torch.equal(pll, want)
    assert dummy is None
    for a, b in zip(hdlc, demod.init_hdlc(48, "cpu")):
        assert torch.equal(a, b)


def test_stream_fir_hdlc_shift_equals_the_chain():
    """On a capture with frames, so that the deframer reaches its data
    state and the register fills: two passes, the carry handed on."""
    x = torch.from_numpy(captures.mixed(24, 2048, seed=5).T.copy())
    pll, hdlc, _ = R.stream(x, "stream+fir+dpll+hdlc+shift", 2)
    want_pll, want = _chain_by_pass(x, 2, with_fir=True)
    assert torch.equal(pll, want_pll)
    for a, b in zip(hdlc, want):
        assert torch.equal(a, b)
    assert (hdlc.shiftreg != 0).any()


def test_stream_modes_share_the_chain():
    """hdlc+shift with and without the dummy blocks: the same chain, the
    blocks copied through; without shift the register stays as it was."""
    x = torch.from_numpy(captures.mixed(16, 1024, seed=6).T.copy())
    dummy = torch.arange(R.N_DUMMY * 16, dtype=torch.int32).reshape(-1, 16)
    a = R.stream(x, "stream+dpll+hdlc+shift", 2)
    b = R.stream(x, "stream+blocks+dpll+hdlc+shift", 2, dummy)
    for u, v in zip((a[0], *a[1]), (b[0], *b[1])):
        assert torch.equal(u, v)
    assert torch.equal(b[2], dummy)
    seed = torch.from_numpy(_seeds(16))
    p1, h1 = R.chain(seed, 512, "dpll+hdlc")
    p2, h2 = R.chain(seed, 512, "dpll+hdlc+shift")
    assert torch.equal(p1, p2) and torch.equal(h1.state, h2.state)
    assert not h1.shiftreg.any()


def test_wrappers_reject_bad_arguments():
    seed = torch.from_numpy(_seeds(4))
    with pytest.raises(ValueError):
        R.chain(seed, 64, "dpll+shift")
    with pytest.raises(ValueError):
        R.chain(seed, 16, "dpll")
    x = R.build_input(seed, 1000)
    with pytest.raises(ValueError):
        R.stream(x, "stream+dpll", 1)                  # steps % 512
    x = R.build_input(seed, 1024)
    with pytest.raises(ValueError):
        R.stream(x, "stream+blocks+dpll+hdlc+shift", 1)   # no dummy
    assert R.passes_for(1 << 17) == 32 and R.passes_for(1 << 23) == 1


def test_bounds_count_what_the_modes_run():
    """R1's bound is its integer operations; R2's the larger of its
    input's bytes and its operations (the lobe FIR's float32 ones on
    their own pipe)."""
    ms, by = R.bound_ms("dpll", 4096, 1 << 22)
    assert by == "operations"
    assert ms == pytest.approx(4096 * (1 << 22) * 14 / (R.INT32_TOPS * 1e9))
    ms_f, _ = R.bound_ms("stream+fir+dpll+hdlc+shift", 4096, 1 << 17, 32)
    ms_s, _ = R.bound_ms("stream+dpll+hdlc+shift", 4096, 1 << 17, 32)
    assert ms_f >= ms_s > 0


def test_card_bound_is_the_slowest_of_bytes_and_each_pipe():
    """``card.bound_ms``: bytes over the HBM rate against each kind of
    operation over its own rate, the larger one named."""
    from gnuais_tpu_torch import card
    assert card.bound_ms(3.35e9) == (pytest.approx(1.0), "bytes")
    ms, by = card.bound_ms(3.35e9, (67e9, card.F32_TFLOPS),
                           (2 * 495e9, card.TF32_TFLOPS))
    assert (ms, by) == (pytest.approx(2.0), "operations")
    assert card.bound_ms(0, (16.75e9, card.INT32_TOPS)) == (
        pytest.approx(1.0), "operations")
