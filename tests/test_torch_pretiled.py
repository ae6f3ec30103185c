"""The pretiled ingest (``tile_superblock``, ``pretiled_streams``) and the
convolution FIR (``fir_conv``, ``exact_fir=False``) of the port on CPU
tensors, against its row-major path and the JAX package.

The port's pretiled layout is time-major [K, T, S], not the TPU
kernel's [K, nt*T, 8, 128] stream tiles, so the tiled arrays are never
compared: the decoded frames and carries are, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu import constants as C
from gnuais_tpu.ops import fir as jfir
from gnuais_tpu.ops import fused as jfused
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.ops import fir as tfir
from gnuais_tpu_torch.ops import fused as tfused
from gnuais_tpu_torch.runtime import pipeline as tpipe

from test_torch_fused import _eq, _same_step

FLAGS = dict(fused_pipeline=True, assume_full=True, with_peak=False)


def _frames_equal(a, b, what=""):
    for name, x, y in zip(a._fields, convert.frames_to_numpy(a),
                          convert.frames_to_numpy(b)):
        _eq(x, y, f"{what} {name}")


def _carries_equal(a, b, what=""):
    for i, (x, y) in enumerate(zip(convert.carry_to_numpy(a),
                                   convert.carry_to_numpy(b))):
        _eq(x, y, f"{what} carry leaf {i}")


def test_tile_superblock_is_time_major_per_block():
    s, k, t = 5, 3, 8
    x = torch.arange(s * k * t, dtype=torch.int16).reshape(s, k * t)
    tiled = tfused.tile_superblock(x, k)
    assert tiled.shape == (k, t, s) and tiled.is_contiguous()
    for b in range(k):
        assert torch.equal(tiled[b], x[:, b * t:(b + 1) * t].t())
    with pytest.raises(ValueError):
        tfused.tile_superblock(x, 5)


@pytest.mark.parametrize("compact", [False, True], ids=["b2", "b1"])
def test_pretiled_block_equals_row_major(compact):
    """decode_block on the time-major block equals the row-major call
    with the same flags: FrameBatch and carry (the history read from the
    last 36 rows), from a carry that is not the initial one."""
    s, t = 12, 4096
    x = captures.mixed(s, 2 * t, seed=51)
    c0, _, _ = tpipe.decode_block(torch.from_numpy(x[:, :t]), t,
                                  tpipe.init_carry(s, "cpu"), frame_slots=8,
                                  fused_pipeline=True)
    xb = torch.from_numpy(np.ascontiguousarray(x[:, t:]))
    kw = dict(frame_slots=8, block_base=t, kernel_compact=compact,
              device_crc=True, **FLAGS)
    rc, rf, rp = tpipe.decode_block(xb, t, c0, **kw)
    pc, pf, pp = tpipe.decode_block(tfused.tile_superblock(xb, 1)[0], t, c0,
                                    pretiled_streams=s, **kw)
    _frames_equal(rf, pf)
    _carries_equal(rc, pc)
    assert torch.equal(rp, pp) and not pp.any()
    assert torch.equal(pc.history, xb[:, -C.FIR_LEN:].to(torch.float32))
    assert int(rf.count.sum()) > 0


def test_pretiled_matches_jax_pretiled_interpret():
    """One JAX pretiled decode (its own tile_superblock layout, kernel B2
    in interpret mode, compact_candidates) against the port's pretiled
    decode: FrameBatch and carry bitwise."""
    s, t = 4, 2560
    x = captures.wrong_size_and_crc(s, t, seed=52)
    jc, jf, _ = jpipe.decode_block(
        jfused.tile_superblock(jnp.asarray(x), 1)[0], jnp.int32(t),
        jpipe.init_carry(s), frame_slots=8, block_base=99,
        pretiled_streams=s, **FLAGS)
    tc, tf, _ = tpipe.decode_block(
        tfused.tile_superblock(torch.from_numpy(x), 1)[0], t,
        tpipe.init_carry(s, "cpu"), frame_slots=8, block_base=99,
        pretiled_streams=s, **FLAGS)
    _same_step(jc, jf, tc, tf)
    assert int(np.asarray(jf.count).sum()) > 0


@pytest.mark.parametrize("compact", [False, True], ids=["b2", "b1"])
def test_pretiled_superblock_equals_sequential_blocks(compact):
    """decode_superblock over [K, T, S] equals K sequential row-major
    decode_block calls, block by block."""
    s, t, k = 8, 1024, 3
    x = torch.from_numpy(captures.mixed(s, k * t, seed=53))
    kw = dict(frame_slots=8, kernel_compact=compact, **FLAGS)
    sc, sf, sp = tpipe.decode_superblock(
        tfused.tile_superblock(x, k), k * t, tpipe.init_carry(s, "cpu"), k,
        block_base=7, pretiled_streams=s, **kw)
    c = tpipe.init_carry(s, "cpu")
    for b in range(k):
        c, f, _ = tpipe.decode_block(
            x[:, b * t:(b + 1) * t], t, c, block_base=7 + b * t, **kw)
        _frames_equal(f, tpipe.demod.FrameBatch(*(v[b] for v in sf)),
                      f"block {b}")
    _carries_equal(c, sc)
    assert int(sf.count.sum()) > 0 and not sp.any()


@pytest.mark.parametrize("nv", [4096 - 700, 20])
@pytest.mark.parametrize("compact", [False, True], ids=["b2", "b1"])
def test_pretiled_short_block_matches_jax_row_major(compact, nv):
    """A short final block (no assume_full) through the port's pretiled
    decode equals JAX's row-major decode of the same block (its exact
    chain, which the fused branches equal after compaction): FrameBatch
    and carry bitwise, the history read from the time-major rows before
    row n_valid (history included when n_valid < 36)."""
    s, t = 6, 4096
    x = captures.mixed(s, t, seed=55)
    hist = captures.garbage(s, C.FIR_LEN, seed=56).astype(np.float32)
    jc0 = jpipe.init_carry(s)._replace(history=jnp.asarray(hist))
    tc0 = tpipe.init_carry(s, "cpu")._replace(history=torch.from_numpy(hist))
    jc, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(nv), jc0,
                                   frame_slots=8, block_base=321)
    tc, tf, _ = tpipe.decode_block(
        tfused.tile_superblock(torch.from_numpy(x), 1)[0], nv, tc0,
        frame_slots=8, block_base=321, pretiled_streams=s,
        fused_pipeline=True, kernel_compact=compact, with_peak=False)
    _same_step(jc, jf, tc, tf)
    if nv > t // 2:
        assert int(np.asarray(jf.count).sum()) > 0


def test_pretiled_rejects_what_it_cannot_take():
    s, t = 4, 1024
    c = tpipe.init_carry(s, "cpu")
    x = torch.zeros((t, s), dtype=torch.int16)
    with pytest.raises(ValueError):        # the peak needs the row view
        tpipe.decode_block(x, t, c, pretiled_streams=s, fused_pipeline=True,
                           assume_full=True)
    with pytest.raises(ValueError):        # assume_full is checked
        tpipe.decode_block(x, t - 4, c, pretiled_streams=s, **FLAGS)
    with pytest.raises(ValueError):        # not [T, S]
        tpipe.decode_block(x.t(), t, c, pretiled_streams=s, **FLAGS)


@pytest.mark.parametrize("nv", [4096, 1000, 20])
def test_fir_conv_matches_jax(nv):
    """fir_conv against JAX's (lax.conv at Precision.HIGHEST).  The two
    sum the 36 products in different orders, so each output may differ
    by the float32 reassociation bound, 2 * 36 * 2^-24 times the sum of
    the products' magnitudes; the carried history is a copy of inputs
    and equal bitwise."""
    s, t = 8, 4096
    x = captures.noisy_frames(s, t, seed=nv)
    h = captures.garbage(s, C.FIR_LEN, seed=nv + 1).astype(np.float32)
    jo, jh = jfir.fir_conv(jnp.asarray(x), jnp.asarray(h),
                           n_valid=jnp.int32(nv))
    to, th = tfir.fir_conv(torch.from_numpy(x), torch.from_numpy(h),
                           n_valid=nv)
    full = np.concatenate([h, x.astype(np.float32)], axis=1)
    taps = np.abs(np.asarray(C.FIR_TAPS, np.float64))
    mag = sum(np.abs(full[:, i:i + t]) * taps[i] for i in range(C.FIR_LEN))
    assert to.dtype == torch.float32 and to.shape == (s, t)
    assert np.all(np.abs(to.numpy() - np.asarray(jo)) <= 2 * 36 * 2**-24 * mag)
    _eq(np.asarray(jh), th.numpy(), "history")


def test_fir_conv_decodes_like_jax():
    """The exact_fir=False chain in both packages decodes the same
    frames from a capture (the same payloads, lengths and positions)."""
    s, t = 8, 4096
    x = captures.noisy_frames(s, t, seed=54)
    _, jf, _ = jpipe.decode_block(jnp.asarray(x), jnp.int32(t),
                                  jpipe.init_carry(s), frame_slots=8,
                                  exact_fir=False)
    _, tf, _ = tpipe.decode_block(torch.from_numpy(x), t,
                                  tpipe.init_carry(s, "cpu"), frame_slots=8,
                                  exact_fir=False)
    for name in ("count", "words", "length", "start", "end"):
        _eq(np.asarray(getattr(jf, name)),
            getattr(convert.frames_to_numpy(tf), name), name)
    assert int(np.asarray(jf.count).sum()) >= s
