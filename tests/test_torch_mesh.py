"""The port's grid steps (``gnuais_tpu_torch.parallel``: ``mesh``,
``halo``, ``sharded``) against the JAX package's on the CPU, on the same
inputs made from a seed with numpy: the JAX side on conftest's 8 virtual
CPU devices, the port on 8 logical shards of the CPU.
``make_sharded_decode`` bitwise on every carry and frame leaf against
JAX's and against the unsharded step (the exact chain, and kernel B1's
plain version with ``kernel_compact``); ``fir_time_sharded`` bitwise on
1 x 8 and 2 x 4 grids, equal to the sequential FIR; the streams x time
step on a 2 x 4 grid (kernel B2's plain version; 1280-sample overlap
and extension, as the dry run takes) with a frame across a shard
boundary, chained super-blocks and per-row DPLL phases: every
``TimeParFrames`` leaf and the drained frames equal to JAX's; and the
dry run on 8 shards.  No tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnuais_tpu.golden import encoder as E
from gnuais_tpu_torch import convert

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
O = E_ = 1280


def _batch(n_streams, t=8192):
    """tests/test_sharding.py's batch, each row shifted a little."""
    audio = E.synthesize_capture(
        [E.make_type123(1, 257012345, 59.9, 10.7), E.make_type5(257099999)],
        gap_bits=48)
    batch = np.zeros((n_streams, t), dtype=np.int16)
    for s in range(n_streams):
        n = min(len(audio), t - 40 * s)
        batch[s, 40 * s:40 * s + n] = audio[:n]
    return batch


def _leaves_equal(port, theirs, what):
    for i, (a, b) in enumerate(zip(port, theirs)):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        if a.dtype != b.dtype:
            a = a.view(b.dtype)
        assert a.shape == b.shape and np.array_equal(a, b), (what, i)


@needs_mesh
@pytest.mark.parametrize("compact", [False, True],
                         ids=["exact_chain", "kernel_compact"])
def test_stream_sharded_matches_jax_and_unsharded(compact):
    from gnuais_tpu.parallel import mesh as JM
    from gnuais_tpu.parallel.sharded import make_sharded_decode as jax_msd
    from gnuais_tpu.runtime import pipeline as JP
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.sharded import make_sharded_decode
    from gnuais_tpu_torch.runtime import pipeline as pl
    s, t = 8, 8192
    batch = _batch(s, t)
    kw = dict(fused_pipeline=True, kernel_compact=True) if compact else {}
    mesh = M.make_stream_mesh(8, device="cpu")
    assert mesh.shape == {"streams": 8, "time": 1}
    c1, f1, p1 = make_sharded_decode(mesh, frame_slots=16, **kw)(
        batch, t, pl.init_carry(s, "cpu"))
    c2, f2, p2 = pl.decode_block(torch.from_numpy(batch), t,
                                 pl.init_carry(s, "cpu"), frame_slots=16,
                                 **kw)
    def flat(c, f, p):
        return (convert.carry_to_numpy(c) + list(convert.frames_to_numpy(f))
                + [p.numpy()])
    for a, b in zip(flat(c1, f1, p1), flat(c2, f2, p2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [int(c) for c in f1.count] == [2] * s
    # JAX's step on the exact chain: its kernel B1 in interpret mode
    # would take over a minute, and B1 decodes as the exact chain does
    cj, fj, pj = jax_msd(JM.make_stream_mesh(), frame_slots=16)(
        jnp.asarray(batch), jnp.int32(t), JP.init_carry(s))
    _leaves_equal(convert.carry_to_numpy(c1), jax.tree.leaves(cj), "carry")
    _leaves_equal(convert.frames_to_numpy(f1), list(fj), "frames")
    _leaves_equal([p1], [pj], "peak")


def test_stream_sharded_superblock_and_refusals():
    """superblock 2: FrameBatch leaves lead with [2], equal to two chained
    unsharded blocks; rows that do not split over the shards raise."""
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.sharded import make_sharded_decode
    from gnuais_tpu_torch.runtime import pipeline as pl
    s, t = 4, 2048
    batch = _batch(s, 2 * t)
    mesh = M.make_grid_mesh(2, 1, device="cpu")
    step = make_sharded_decode(mesh, frame_slots=8, fused_pipeline=True,
                               superblock=2)
    c1, f1, p1 = step(torch.from_numpy(batch), 2 * t, pl.init_carry(s, "cpu"))
    c2, f2, p2 = pl.decode_superblock(torch.from_numpy(batch), 2 * t,
                                      pl.init_carry(s, "cpu"), 2,
                                      frame_slots=8, fused_pipeline=True)
    assert f1.count.shape == (2, s)
    for a, b in zip(f1, f2):
        assert torch.equal(a, b)
    assert torch.equal(p1, p2) and torch.equal(c1.history, c2.history)
    with pytest.raises(ValueError, match="do not split"):
        step(torch.from_numpy(batch[:3]), 2 * t, pl.init_carry(3, "cpu"))


@needs_mesh
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
def test_fir_time_sharded_matches_jax_and_sequential(shape):
    from gnuais_tpu.ops import fir as JF
    from gnuais_tpu.parallel import mesh as JM
    from gnuais_tpu.parallel.halo import fir_time_sharded as jax_fts
    from gnuais_tpu_torch.ops import fir
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.halo import fir_time_sharded
    rng = np.random.default_rng(sum(shape))
    s, t = 8, 4096
    x = rng.integers(-30000, 30000, (s, t), dtype=np.int16)
    hist = rng.normal(0, 1000, (s, 36)).astype(np.float32)
    got, new_hist = fir_time_sharded(torch.from_numpy(x),
                                     torch.from_numpy(hist),
                                     M.make_grid_mesh(*shape, device="cpu"))
    want, want_hist = fir.fir_exact(torch.from_numpy(x),
                                    torch.from_numpy(hist))
    assert torch.equal(got, want) and torch.equal(new_hist, want_hist)
    jmesh = JM.make_grid_mesh(*shape)
    kw = {} if shape[0] > 1 else {"stream_axis": None}
    jgot, jhist = jax_fts(jnp.asarray(x), jnp.asarray(hist), jmesh, **kw)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(jgot).view(np.int32))
    assert np.array_equal(new_hist.numpy(), np.asarray(jhist))
    assert np.array_equal(np.asarray(JF.fir_exact(jnp.asarray(x),
                                                  jnp.asarray(hist))[0]),
                          np.asarray(jgot))


def test_exchange_halos_moves_each_neighbours_edges():
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.halo import exchange_halos
    mesh = M.make_grid_mesh(2, 3, device="cpu")
    tails = [torch.full((2, 4), k, dtype=torch.int16) for k in range(6)]
    heads = [torch.full((2, 3), 10 + k, dtype=torch.int16) for k in range(6)]
    left, right = exchange_halos(mesh, tails, heads)
    assert [None if v is None else int(v[0, 0]) for v in left] == \
        [None, 0, 1, None, 3, 4]
    assert [None if v is None else int(v[0, 0]) for v in right] == \
        [11, 12, None, 14, 15, None]
    assert exchange_halos(mesh, tails)[1] == [None] * 6


def _straddling(rng, tg, n_rows):
    """n_rows streams of noisy traffic, each with one type 5 frame laid
    across the first shard boundary of a 2560-sample shard."""
    rows = np.zeros((n_rows, tg), dtype=np.int16)
    for r in range(n_rows):
        audio = E.synthesize_capture(
            [E.make_type5(257000001 + r)]
            + [E.random_payload(rng) for _ in range(4)],
            gap_bits=90 + 10 * r, lead_in_bits=(2560 - 1200) // 5)
        n = min(len(audio), tg)
        rows[r, :n] = audio[:n]
    return np.clip(rows + rng.normal(0, 250, rows.shape), -32768,
                   32767).astype(np.int16)


def _run_both(shape, blocks, row_phase=None, t_loc=2560):
    """Each block through the port's and JAX's 2-D step in turn, the
    edges handed on; returns per package the TimeParFrames (as numpy)
    and the drained per-stream frames of every block."""
    from gnuais_tpu.parallel import mesh as JM
    from gnuais_tpu.parallel import sharded as JS
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel import sharded as S
    steps = {"torch": S.make_multichip_step(
        M.make_grid_mesh(*shape, device="cpu"), frame_slots=16, overlap=O,
        extension=E_),
        "jax": JS.make_multichip_step(JM.make_grid_mesh(*shape),
                                      frame_slots=16, overlap=O,
                                      extension=E_)}
    res = {}
    for pkg, step in steps.items():
        drain = S.drain_timepar_frames if pkg == "torch" else \
            JS.drain_timepar_frames
        leaves, frames, prev = [], [], None
        for g, blk in enumerate(blocks):
            s, tg = blk.shape
            prev_tail = (np.zeros((s, O), np.int16) if g == 0
                         else blocks[g - 1][:, -O:])
            nxt = (blocks[g + 1][:, :E_] if g + 1 < len(blocks)
                   else np.zeros((s, E_), np.int16))
            valid_end = (g + 1) * tg + (E_ if g + 1 < len(blocks) else 0)
            kw = {} if row_phase is None else {"row_phase": row_phase}
            if pkg == "torch":
                tp = step(blk, valid_end, g * tg, prev_tail, nxt, **kw)
                leaves.append([v.numpy() for v in tp])
            else:
                tp = step(jnp.asarray(blk), jnp.int32(valid_end),
                          jnp.int32(g * tg), jnp.asarray(prev_tail),
                          jnp.asarray(nxt), **kw)
                leaves.append([np.asarray(v) for v in tp])
            per = drain(tp, 16, prev_starts=prev)
            prev = [(lst[-1][0] if lst else (prev[i] if prev else -10 ** 9))
                    for i, lst in enumerate(per)]
            frames.append([[(st, en, f.payload_bits[:f.bufferlen].tobytes())
                            for st, en, f in lst] for lst in per])
        res[pkg] = leaves, frames
    return res


def _assert_same_steps(res, start_jitter=0):
    """Every leaf and drained frame equal; with start_jitter, the data
    starts within that many samples (the rest still bitwise)."""
    (lt, ft), (lj, fj) = res["torch"], res["jax"]
    for b, (a_blk, b_blk) in enumerate(zip(lt, lj)):
        for name, a, c in zip(("words", "length", "start", "end", "count",
                               "lost2", "peak"), a_blk, b_blk):
            if name == "words":
                c = c.view(np.int32)
            assert a.shape == c.shape, (b, name)
            if name == "start":
                assert np.abs(a - c).max() <= start_jitter, (b, name)
            else:
                assert np.array_equal(a, c), (b, name)
    drop = (lambda f: [[(en, bits) for _st, en, bits in lst] for lst in f]) \
        if start_jitter else (lambda f: f)
    assert [drop(f) for f in ft] == [drop(f) for f in fj]


@needs_mesh
def test_multichip_step_2x4_matches_jax_with_a_straddling_frame():
    rng = np.random.default_rng(29)
    tg = 4 * 2560
    rows = _straddling(rng, tg, 4)
    res = _run_both((2, 4), [rows])
    _assert_same_steps(res)
    leaves, frames = res["torch"]
    count = leaves[0][4]
    assert count.shape == (4, 4) and count.sum() >= 12
    for r, lst in enumerate(frames[0]):
        # the type 5 frame starts in shard 0 and ends in shard 1
        st, en, _bits = lst[0]
        assert st < 2560 < en, (r, st, en)


@needs_mesh
def test_multichip_step_chained_superblocks_match_jax():
    """Two super-blocks in turn with the edges handed on, and a frame
    laid across the seam between them."""
    rng = np.random.default_rng(37)
    tg = 4 * 2560
    stream = np.zeros((2, 2 * tg), np.int16)
    for r in range(2):
        audio = E.synthesize_capture(
            [E.random_payload(rng) for _ in range(12)], gap_bits=60,
            lead_in_bits=40 + 7 * r)
        n = min(len(audio), 2 * tg)
        stream[r, :n] = audio[:n]
    stream = np.clip(stream + rng.normal(0, 250, stream.shape), -32768,
                     32767).astype(np.int16)
    res = _run_both((2, 4), [stream[:, :tg], stream[:, tg:]])
    _assert_same_steps(res)
    _leaves, frames = res["torch"]
    assert all(len(frames[1][r]) >= 3 for r in range(2))
    ends = [en for blk in frames for lst in blk for _st, en, _b in lst]
    starts = [st for blk in frames for lst in blk for st, _en, _b in lst]
    assert any(st < tg <= en for st, en in zip(starts, ends)), \
        "no frame across the super-block seam"


@needs_mesh
def test_multichip_step_row_phase_matches_jax():
    """Per-row DPLL phase offsets (the grouped session's row segments):
    the same owned frames and leaves as JAX's step with the same
    offsets, and other leaves than without them.  One owned frame's data
    start lies a sample from JAX's: each window's FIR starts from a zero
    history, where the port keeps the subnormal sums of the first
    samples (as the reference C code does) and XLA on the CPU flushes
    them to 0, so the two slicers see a transition at a different sample
    of the overlap (ROADMAP section 3); its payload, end and every other
    leaf are bitwise JAX's.  The witness: with the port's CPU arithmetic
    flushing subnormals as XLA's does, every leaf and frame, the starts
    included, is bitwise JAX's."""
    from gnuais_tpu_torch import constants as C
    rng = np.random.default_rng(43)
    tg = 4 * 2560
    rows = _straddling(rng, tg, 4)
    phase = ((C.PLL_INC * (np.arange(4, dtype=np.int64) * 77777 % 65536))
             % 65536).astype(np.int32)
    res = _run_both((2, 4), [rows], row_phase=phase)
    _assert_same_steps(res, start_jitter=1)
    assert not np.array_equal(res["torch"][0][0][2], res["jax"][0][0][2])
    assert torch.set_flush_denormal(True)
    try:
        flushed = _run_both((2, 4), [rows], row_phase=phase)
    finally:
        torch.set_flush_denormal(False)
    _assert_same_steps(flushed)
    plain = _run_both((2, 4), [rows])
    assert not all(np.array_equal(a, b) for a, b in
                   zip(res["torch"][0][0], plain["torch"][0][0]))


def test_dryrun_multichip_on_8_cpu_shards(capsys):
    from gnuais_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(8, "cpu")
    assert "dryrun_multichip(8): ok (1D streams=8; 2D 4x2)" in \
        capsys.readouterr().out


def test_grid_steps_refuse_what_does_not_split():
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.sharded import make_multichip_step
    step = make_multichip_step(M.make_grid_mesh(2, 2, device="cpu"),
                               overlap=O, extension=E_)
    z = np.zeros
    with pytest.raises(ValueError, match="do not split over 2 time"):
        step(z((2, 5121), np.int16), 0, 0, z((2, O), np.int16),
             z((2, E_), np.int16))
    with pytest.raises(ValueError, match="do not split over the 2 streams"):
        step(z((3, 5120), np.int16), 0, 0, z((3, O), np.int16),
             z((3, E_), np.int16))
    with pytest.raises(ValueError, match="shorter than the overlap"):
        step(z((2, 2048), np.int16), 0, 0, z((2, O), np.int16),
             z((2, E_), np.int16))
