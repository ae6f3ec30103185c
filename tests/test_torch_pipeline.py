"""The port's runtime against the JAX package and the committed
fixtures: carries across packages and across chained blocks, the
receiver through ``DecodeSession`` (both backends) and the batch
session.  Bitwise where the JAX side is bit-exact; the fixture stdout
byte for byte."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu.runtime.batch import BatchSession as JaxBatchSession
from gnuais_tpu.runtime.session import DecodeSession
from gnuais_tpu_torch import captures, convert
from gnuais_tpu_torch.runtime import pipeline as tpipe
from gnuais_tpu_torch.runtime.batch import BatchSession

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def capture():
    return np.fromfile(FIX / "standard_capture.raw", dtype="<i2")


@pytest.fixture(scope="module")
def expected_stdout():
    return (FIX / "standard_capture.stdout").read_text().splitlines()


def _jax_leaves(carry):
    return [np.asarray(a) for a in jax.tree.leaves(carry)]


def _eq_leaves(a, b):
    assert len(a) == len(b) == convert.N_LEAVES
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype, y.dtype)
        assert np.array_equal(x, y), i


def test_carry_round_trip_across_packages():
    """A JAX carry (register words with the top bit set) crosses into
    the port and back unchanged, uint32 leaves by view; a block decoded
    from the crossed carry in each package gives the same carry."""
    s, t = 8, 4096
    x = captures.mixed(s, 2 * t, seed=5)
    jc, _, _ = jpipe.decode_block(jnp.asarray(x[:, :t]), jnp.int32(t - 500),
                                  jpipe.init_carry(s), frame_slots=16)
    leaves = _jax_leaves(jc)
    assert leaves[-1].dtype == np.uint32 and (leaves[-1] >> 31).any()
    tc = convert.carry_from_numpy(leaves, "cpu")
    assert tc.hdlc.shiftreg.dtype == torch.int32
    _eq_leaves(leaves, convert.carry_to_numpy(tc))

    jc2, jf2, _ = jpipe.decode_block(jnp.asarray(x[:, t:]), jnp.int32(t), jc,
                                     frame_slots=16, block_base=t)
    tc2, tf2, _ = tpipe.decode_block(torch.from_numpy(x[:, t:]), t, tc,
                                     frame_slots=16, block_base=t)
    _eq_leaves(_jax_leaves(jc2), convert.carry_to_numpy(tc2))
    # and back: the port's carry resumes in JAX
    treedef = jax.tree.structure(jc2)
    back = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in
                                        convert.carry_to_numpy(tc2)])
    _eq_leaves(_jax_leaves(jc2), _jax_leaves(back))
    fn = convert.frames_to_numpy(tf2)
    assert fn.words.dtype == np.uint32
    assert np.array_equal(fn.words, np.asarray(jf2.words))


@pytest.mark.parametrize("fused", [False, True], ids=["exact", "fused"])
def test_chained_blocks_short_tail_match_jax(fused):
    """Three blocks chained through the carry, the last one short, with
    a nonzero block base: every carry leaf and FrameBatch leaf equals the
    JAX exact chain after every block."""
    s, t = 8, 1024
    x = captures.mixed(s, 3 * t, seed=3)
    jc, tc = jpipe.init_carry(s), tpipe.init_carry(s, "cpu")
    total = 0
    for b in range(3):
        xb = x[:, b * t:(b + 1) * t]
        nv = t if b < 2 else 700
        jc, jf, _ = jpipe.decode_block(jnp.asarray(xb), jnp.int32(nv), jc,
                                       frame_slots=8, block_base=5 + b * t)
        tc, tf, _ = tpipe.decode_block(torch.from_numpy(xb), nv, tc,
                                       frame_slots=8, block_base=5 + b * t,
                                       fused_pipeline=fused)
        _eq_leaves(_jax_leaves(jc), convert.carry_to_numpy(tc))
        for name, a, bb in zip(jf._fields, jf, convert.frames_to_numpy(tf)):
            assert np.array_equal(np.asarray(a), bb), (b, name)
        total += int(np.asarray(jf.count).sum())
    assert total > 0


def test_exact_receiver_matches_fixture(capture, expected_stdout):
    res = DecodeSession(lambda n: tpipe.TorchReceiver(n, device="cpu")).run(capture)
    assert res.stdout_lines == expected_stdout
    assert res.counters["A"] == (49, 0, 0)


def test_fused_receiver_matches_fixture(capture, expected_stdout):
    """The fused backend: 1024-sample blocks, CRC filter on the device
    (the plain version on CPU tensors)."""
    res = DecodeSession(
        lambda n: tpipe.TorchReceiver(n, block_len=1024, fused_pipeline=True,
                                      device_crc=True, device="cpu")
    ).run(capture, block_frames=1024)
    assert res.stdout_lines == expected_stdout
    assert res.counters["A"] == (49, 0, 0)


def test_batch_replicated_fixture(capture, expected_stdout):
    names = [f"s{i}" for i in range(4)]
    sess = BatchSession(names, block_len=8192, device="cpu")
    res = sess.run([capture] * 4)
    for name in names:
        assert res.counters[name] == (49, 0, 0)
    for name in names:
        mine = [l.split("] ", 1)[1] for l in res.lines
                if l.startswith(f"[{name}]")]
        assert mine == expected_stdout


def test_batch_session_staging_buffer_kept_across_calls(monkeypatch):
    """Two calls of one session, as the benchmark makes them: full
    streams, then streams of unequal lengths (some shorter than the
    block, one empty, a short last block).  Every block handed to
    ``process`` is the zero-padded assembly of its segments, from the
    same buffer each call; the lines and counters are the JAX batch
    session's, which assembles each block afresh."""
    bl = 4096
    x = captures.mixed(4, 3 * bl, seed=16)
    calls = [[x[i, :bl] for i in range(4)],
             [x[0, bl:2 * bl + 1500], x[1, bl:2 * bl - 1000],
              x[2, bl:bl], x[3, bl:bl + 700]]]
    names = [f"s{i}" for i in range(4)]
    sess = BatchSession(names, block_len=bl, device="cpu")
    seen = []
    process = sess.pipe.process

    def record(block):
        seen.append((block.ctypes.data, block.copy()))
        return process(block)

    monkeypatch.setattr(sess.pipe, "process", record)
    witness = JaxBatchSession(names, block_len=bl)
    want_blocks = []
    for streams in calls:
        total = max(len(s) for s in streams)
        for off in range(0, total, bl):
            want = np.zeros((4, min(bl, total - off)), dtype=np.int16)
            for i, s in enumerate(streams):
                seg = s[off:off + bl]
                want[i, :len(seg)] = seg
            want_blocks.append(want)
        got, ref = sess.run(streams), witness.run(streams)
        assert ref.lines and got.lines == ref.lines
        assert got.counters == ref.counters
        assert got.samples == ref.samples
    assert [b.shape for _, b in seen] == [(4, bl), (4, bl), (4, 1500)]
    for (_, block), want in zip(seen, want_blocks):
        assert np.array_equal(block, want)
    assert {ptr for ptr, _ in seen} == {sess.staging.ctypes.data}
    assert not sess.pinned


def test_batch_pipeline_slot_overflow_raises():
    x = captures.minimal_frames(2, 4096, seed=1)
    pipe = tpipe.BatchPipeline(2, block_len=4096, frame_slots=3,
                               fused_pipeline=True, device_crc=True,
                               device="cpu")
    with pytest.raises(RuntimeError, match="slot overflow"):
        pipe.process(x)


def test_batch_pipeline_rejects_unported_options():
    with pytest.raises(ValueError):
        tpipe.BatchPipeline(1, block_len=1024, device_crc=True, device="cpu")
    with pytest.raises(ValueError):
        tpipe.BatchPipeline(1, block_len=1000, fused_pipeline=True,
                            device="cpu")
    with pytest.raises(ValueError):
        tpipe.BatchPipeline(1, block_len=1024, device="meta")
