"""The port's superblocks and pipelined streaming decoder on CPU tensors:
``decode_superblock`` against K sequential ``decode_block`` calls and
against JAX's ``decode_superblock``, ``process_superblock`` against
per-block ``process``, and ``PipelinedDecoder`` against a sequential
``BatchPipeline`` for every backend flag.  Bitwise (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.runtime import pipeline as tpipe
from gnuais_tpu_torch.runtime.streaming import PipelinedDecoder

FLAGS = {
    "exact": {},
    "fast": dict(fast_dpll=True),
    "fused_frontend": dict(fused_frontend=True),
    "fused_pipeline": dict(fused_pipeline=True, device_crc=True),
}


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _eq_carry(a, b):
    for i, (x, y) in enumerate(zip(convert.carry_to_numpy(a),
                                   convert.carry_to_numpy(b))):
        _eq(x, y, f"carry leaf {i}")


# (S, blocks, n_valid over the superblock, payloads, gap bits): frames
# straddle the 1024-sample seams; the second case ends in a short tail
SUPERBLOCKS = {"seam_straddle": (4, 4, 4 * 1024, 5, 24),
               "short_tail": (3, 3, 2 * 1024 + 700, 4, 32)}


@pytest.mark.parametrize("case", sorted(SUPERBLOCKS))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_superblock_matches_sequential_blocks(case, flags):
    s, k, nv_total, n_pay, gap = SUPERBLOCKS[case]
    t = 1024
    x = captures.noisy_frames(s, k * t, seed=k, n_payloads=n_pay,
                              gap_bits=gap)
    c = tpipe.init_carry(s, "cpu")
    seq = []
    for b in range(k):
        nv = int(np.clip(nv_total - b * t, 0, t))
        c, f, _ = tpipe.decode_block(torch.from_numpy(x[:, b * t:(b + 1) * t]),
                                     nv, c, frame_slots=16, block_base=b * t,
                                     **FLAGS[flags])
        seq.append(f)
    c_sup, frames_k, peak = tpipe.decode_superblock(
        torch.from_numpy(x), nv_total, tpipe.init_carry(s, "cpu"), k,
        frame_slots=16, **FLAGS[flags])
    for b in range(k):
        for name, a, bb in zip(frames_k._fields, frames_k, seq[b]):
            _eq(a[b].numpy(), bb.numpy(), f"block {b} {name}")
    _eq_carry(c, c_sup)
    _eq(peak.numpy(), np.maximum(x[:, :nv_total].max(axis=1), 0)
        .astype(np.int32), "peak")
    assert int(frames_k.count.sum()) >= s


@pytest.mark.parametrize("case", sorted(SUPERBLOCKS))
def test_superblock_matches_jax(case):
    """The exact chain's superblock in both packages: stacked frames and
    the carry leaf by leaf."""
    s, k, nv_total, n_pay, gap = SUPERBLOCKS[case]
    x = captures.noisy_frames(s, k * 1024, seed=k, n_payloads=n_pay,
                              gap_bits=gap)
    jc, jf, jp = jpipe.decode_superblock(jnp.asarray(x), jnp.int32(nv_total),
                                         jpipe.init_carry(s), k,
                                         frame_slots=16)
    tc, tf, tp = tpipe.decode_superblock(torch.from_numpy(x), nv_total,
                                         tpipe.init_carry(s, "cpu"), k,
                                         frame_slots=16)
    for name, a, b in zip(jf._fields, jf, convert.frames_to_numpy(tf)):
        _eq(a, b, name)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jc),
                                   convert.carry_to_numpy(tc))):
        _eq(a, b, f"carry leaf {i}")
    _eq(jp, tp.numpy(), "peak")


def _payloads(per_stream):
    return [[f.payload_bits[:f.bufferlen].tobytes() for f in lst]
            for lst in per_stream]


@pytest.mark.parametrize("flags", ["exact", "fused_pipeline"])
def test_process_superblock_matches_process(flags):
    """One capture of six payloads: block by block through process, and
    in one process_superblock (padded to whole blocks); the same frames
    and counters."""
    audio, sent = captures.payload_capture(np.random.default_rng(4), 6)
    bl = 2048
    pa = tpipe.BatchPipeline(1, block_len=bl, frame_slots=16, device="cpu",
                             **FLAGS[flags])
    fa = []
    for off in range(0, len(audio), bl):
        fa += pa.process(audio[None, off:off + bl])[0]
    pb = tpipe.BatchPipeline(1, block_len=bl, frame_slots=16, device="cpu",
                             **FLAGS[flags])
    fb = pb.process_superblock(audio[None, :])[0]
    assert vars(pa.counters[0]) == vars(pb.counters[0]) == dict(
        receivedframes=6, lostframes=0, lostframes2=0)
    assert _payloads([fa]) == _payloads([fb]) == [
        [p.tobytes() for p in sent]]


def _blocks(s, t, n):
    """n blocks of [S, <= t], the last one short, from frames in noise
    with wrong-size and CRC-reject frames on some streams."""
    x = captures.mixed(s, n * t, seed=n)
    return [x[:, b * t:min((b + 1) * t, n * t - 300)] for b in range(n)]


@pytest.mark.parametrize("flags,superblock", [
    ("exact", 1), ("fast", 1), ("fused_frontend", 1), ("fused_pipeline", 1),
    ("fused_pipeline", 3)])
def test_pipelined_decoder_matches_sequential(flags, superblock):
    """Per submission, the same per-stream frames in the same order as a
    sequential BatchPipeline over the same blocks, and the same
    counters; with superblock=3 each submission carries up to three
    blocks."""
    s, t = 8, 1024
    blocks = _blocks(s, t, 5)
    seq = tpipe.BatchPipeline(s, block_len=t, frame_slots=16, device="cpu",
                              **FLAGS[flags])
    want = [seq.process(b) for b in blocks]
    dec = PipelinedDecoder(s, block_len=t, frame_slots=16, depth=2,
                           superblock=superblock, device="cpu",
                           **FLAGS[flags])
    if superblock > 1:
        groups = [blocks[i:i + superblock]
                  for i in range(0, len(blocks), superblock)]
        submissions = [np.concatenate(g, axis=1) for g in groups]
        want = [[sum((w[i] for w in want[j:j + superblock]), [])
                 for i in range(s)]
                for j in range(0, len(blocks), superblock)]
    else:
        submissions = blocks
    got = dec.run(submissions)
    assert [_payloads(g) for g in got] == [_payloads(w) for w in want]
    assert [vars(c) for c in dec.counters] == [vars(c) for c in seq.counters]
    assert sum(c.receivedframes for c in dec.counters) > s


def test_submit_returns_none_until_depth():
    s, t = 4, 1024
    blocks = _blocks(s, t, 4)
    seq = tpipe.BatchPipeline(s, block_len=t, frame_slots=16, device="cpu")
    want = [seq.process(b) for b in blocks]
    dec = PipelinedDecoder(s, block_len=t, frame_slots=16, depth=2,
                           device="cpu")
    assert dec.submit(blocks[0]) is None
    assert dec.submit(blocks[1]) is None
    assert _payloads(dec.submit(blocks[2])) == _payloads(want[0])
    assert _payloads(dec.submit(blocks[3])) == _payloads(want[1])
    assert [_payloads(r) for r in dec.flush()] == [_payloads(w)
                                                   for w in want[2:]]
    assert dec.flush() == []


def test_slot_overflow_raised_at_drain():
    """A block with more frames than slots is accepted by submit and
    raises when it is drained."""
    x = captures.minimal_frames(2, 4096, seed=1)
    dec = PipelinedDecoder(2, block_len=4096, frame_slots=3, depth=2,
                           fused_pipeline=True, device_crc=True,
                           device="cpu")
    assert dec.submit(x) is None
    with pytest.raises(RuntimeError, match="slot overflow"):
        dec.flush()


def test_pipelined_decoder_rejects_what_does_not_fit():
    dec = PipelinedDecoder(2, block_len=1024, device="cpu")
    with pytest.raises(ValueError):
        dec.submit(np.zeros((3, 1024), dtype=np.int16))
    with pytest.raises(ValueError):
        dec.submit(np.zeros((2, 1025), dtype=np.int16))
    with pytest.raises(ValueError):
        PipelinedDecoder(2, block_len=1000, fused_frontend=True, device="cpu")
