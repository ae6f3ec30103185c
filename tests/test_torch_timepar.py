"""The port's throughput modes (``gnuais_tpu_torch.parallel``) against the
JAX package's on the CPU, on the same captures made from a seed with
numpy: ``time_parallel_decode`` (the lanes; kernel B1's plain version
here) against JAX's with ``chunk_len`` 8192, through the dense drain and
the slot drain; ``dense_frames``/``extract_dense`` alone; and
``TimeParSession`` on a 1 x 1 grid (kernel B2's plain version) against
JAX's on ``make_grid_mesh(1, 1)`` with 4096-sample super-blocks, with a
snapshot crossing packages.  Frames, starts, ends and counters must be
equal: no tolerance.
"""

import numpy as np
import pytest
import torch

from gnuais_tpu.golden import encoder as E

CHUNK = 8192
SB = 4096


def _with_noise(audio, rng, std):
    return np.clip(audio + rng.normal(0, std, len(audio)), -32768,
                   32767).astype(np.int16)


def _capture(name: str) -> np.ndarray:
    """tests/test_timepar.py's captures, cut to a few lanes."""
    if name == "many chunks":
        rng = np.random.default_rng(1)
        return E.synthesize_capture(
            [E.random_payload(rng) for _ in range(30)], gap_bits=64)
    if name == "busy traffic":
        rng = np.random.default_rng(2)
        return E.synthesize_capture(
            [E.random_payload(rng) for _ in range(40)], gap_bits=24)
    if name == "noise":
        rng = np.random.default_rng(3)
        return E.synthesize_capture(
            [E.random_payload(rng) for _ in range(20)], gap_bits=48,
            noise_std=2000.0, seed=3)
    if name == "straddling frame":
        audio = E.synthesize_capture([E.make_type5(257000001)], gap_bits=16,
                                     lead_in_bits=(CHUNK - 500) // 5)
        return np.concatenate([audio, np.zeros(CHUNK, np.int16)])
    if name == "long gaps, noise floor":
        rng = np.random.default_rng(31)
        audio = E.synthesize_capture(
            [E.random_payload(rng) for _ in range(6)], gap_bits=2000)
        return _with_noise(audio, rng, 300)
    if name == "wrong CRC":
        rng = np.random.default_rng(47)
        audio = E.synthesize_capture(
            [E.random_payload(rng) for _ in range(10)], gap_bits=600).copy()
        # one inverted 5-sample bit cell inside the fourth frame
        cell = 3 * (len(audio) // 10) + 800
        audio[cell:cell + 5] = -audio[cell:cell + 5]
        return _with_noise(audio, rng, 200)
    raise KeyError(name)


CAPTURES = ["many chunks", "busy traffic", "noise", "straddling frame",
            "long gaps, noise floor", "wrong CRC"]


def _frames(res):
    return [(s, e, f.bufferlen, f.payload_bits[:f.bufferlen].tobytes())
            for s, e, f in zip(res.starts, res.ends, res.frames)]


def _lanes_pair(audio, **kw):
    from gnuais_tpu.parallel import timepar as J
    from gnuais_tpu_torch.parallel import timepar as T
    want = J.time_parallel_decode(audio, chunk_len=CHUNK, **kw)
    got = T.time_parallel_decode(audio, chunk_len=CHUNK, device="cpu", **kw)
    return want, got


def _assert_same_result(want, got):
    assert _frames(got) == _frames(want)
    assert (got.chunks, got.wrong_crc, got.wrong_size, got.peak) == \
        (want.chunks, want.wrong_crc, want.wrong_size, want.peak)


@pytest.mark.parametrize("capture", CAPTURES)
def test_lanes_match_jax_dense_drain(capture):
    audio = _capture(capture)
    want, got = _lanes_pair(audio)
    assert got.chunks >= 3
    assert want.frames, "the capture decoded nothing"
    _assert_same_result(want, got)
    if capture == "wrong CRC":
        assert got.wrong_crc >= 1


@pytest.mark.parametrize("capture", ["many chunks", "wrong CRC"])
def test_lanes_match_jax_slot_drain(capture):
    """dense_cap below the frames of the call: both packages take the
    per-lane slot drain."""
    audio = _capture(capture)
    want, got = _lanes_pair(audio, dense_cap=4)
    _assert_same_result(want, got)


def test_lanes_timings_and_grid_phase():
    """The tracer gets the three stages as spans under a profiler; lane
    0's negative base reduces with floored modulo (never fmod) in the
    DPLL's grid init."""
    from gnuais_tpu import constants as JC
    from gnuais_tpu_torch.parallel import timepar as T
    carry = T._lane_carry(5, 1000, 4096, torch.device("cpu"))
    bases = np.arange(5) * 1000 - 4096
    assert carry.dpll.pll.dtype == torch.int32
    assert carry.dpll.pll.tolist() == [int(b * JC.PLL_INC % 65536)
                                       for b in bases]
    from torch.profiler import ProfilerActivity, profile
    from gnuais_tpu_torch.runtime import trace
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        T.time_parallel_decode(_capture("many chunks")[:20000],
                               chunk_len=CHUNK, device="cpu")
    lanes = {k: v for k, v in trace.totals().items()
             if k.startswith("lanes.")}
    assert set(lanes) == {"lanes.gather", "lanes.decode", "lanes.drain"}
    assert all(t.calls == 1 and t.ms > 0 for t in lanes.values())


def _jax_frames(frames):
    """A port FrameBatch as the JAX FrameBatch (numpy leaves)."""
    import jax.numpy as jnp
    from gnuais_tpu.ops import demod as JD
    from gnuais_tpu_torch import convert
    return JD.FrameBatch(*map(jnp.asarray, convert.frames_to_numpy(frames)))


@pytest.mark.parametrize("cap", [64, 7])
def test_dense_frames_and_extract_dense_match_jax(cap):
    """On one decoded FrameBatch: every DenseFrames leaf bitwise equal to
    JAX's ``demod.dense_frames`` (cap 7 overflows), and ``extract_dense``
    gives JAX's per-stream (start, end, Frame) lists."""
    from gnuais_tpu.ops import demod as JD
    from gnuais_tpu.runtime import pipeline as JP
    from gnuais_tpu_torch.ops import demod
    from gnuais_tpu_torch.runtime import pipeline as pl
    rng = np.random.default_rng(19)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(5)],
                                 gap_bits=64)
    s, t = 3, -(-len(audio) // 512) * 512
    x = np.zeros((s, t), dtype=np.int16)
    for i in range(s):
        x[i, i * 40:len(audio) + i * 40] = audio[:t - i * 40]
    _c, frames, _p = pl.decode_block(torch.from_numpy(x), t,
                                     pl.init_carry(s, "cpu"),
                                     frame_slots=16, fused_pipeline=True,
                                     kernel_compact=True)
    mine = demod.dense_frames(frames, cap)
    theirs = JD.dense_frames(_jax_frames(frames), cap)
    for name, a, b in zip(demod.DenseFrames._fields, mine, theirs):
        a = a.numpy()
        b = np.asarray(b)
        if name == "words":
            b = b.view(np.int32)
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert int(mine.total) == min(15, cap)
    assert int(mine.over) == max(0, 15 - cap)

    def flat(per):
        return [[(st, en, f.crc_ok, f.payload_bits[:f.bufferlen].tobytes())
                 for st, en, f in lst] for lst in per]
    assert flat(pl.extract_dense(mine, s)) == \
        flat(JP.extract_dense(theirs, s))


def _session_capture():
    rng = np.random.default_rng(83)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(8)],
                                 gap_bits=500)
    return _with_noise(audio, rng, 200)


def _pushes(stream):
    n = len(stream) // SB
    pushes = [stream[i * SB:(i + 1) * SB] for i in range(n)]
    tail = stream[n * SB:]
    if len(tail):
        pushes.append(np.pad(tail, (0, SB - len(tail))))
    return pushes, len(tail) or None


def _run_session(sess, pushes, n_valid):
    got = []
    for p in pushes:
        out = sess.push(p[None, :])
        if out:
            got += out[0]
    got += sess.flush(n_valid=n_valid)[0]
    return got


def _flat(items):
    return [(s, e, f.payload_bits[:f.bufferlen].tobytes())
            for s, e, f in items]


def _counters(sess):
    return (sess.received, sess.wrong_crc, sess.wrong_size, sess.last_peak)


def test_session_matches_jax_with_snapshot_across_packages():
    """TimeParSession on a 1 x 1 grid against JAX's: the same frames,
    starts, ends and counters; a snapshot taken halfway in each package
    (numpy and Python values only) restores into a new session of the
    other and continues identically."""
    from gnuais_tpu.parallel.mesh import make_grid_mesh as jax_mesh
    from gnuais_tpu.parallel.timepar import TimeParSession as JaxSession
    from gnuais_tpu_torch import convert
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    pushes, n_valid = _pushes(_session_capture())
    assert len(pushes) >= 6

    def port():
        return TimeParSession(make_grid_mesh(1, 1, device="cpu"), 1, SB)

    def jax():
        return JaxSession(jax_mesh(1, 1), 1, SB)

    ref_j = jax()
    want = _flat(_run_session(ref_j, pushes, n_valid))
    assert len(want) >= 7
    half = len(pushes) // 2
    for first, second in ((port, jax), (jax, port)):
        a = first()
        head = []
        for p in pushes[:half]:
            out = a.push(p[None, :])
            if out:
                head += out[0]
        snap = convert.snapshot_to_numpy(a.snapshot())
        assert set(snap) == set(JaxSession._SNAP_KEYS)
        assert not any(isinstance(v, torch.Tensor) for v in snap.values())
        b = second()
        b.restore(snap)
        tail = _flat(_run_session(b, pushes[half:], n_valid))
        assert _flat(head) + tail == want
        assert _counters(b)[:3] == _counters(ref_j)[:3]
        assert _counters(b)[3] == _counters(ref_j)[3]


def test_grid_mesh_refuses_more_devices_than_the_process_has(monkeypatch):
    """A grid of more cards than the process sees is refused (the card
    count patched: no card is touched), as is an explicit device list
    shorter than the grid; on the CPU a grid of any size is that many
    logical shards of the one CPU device, and the step runs on it."""
    from gnuais_tpu_torch.parallel import sharded
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    mesh = make_grid_mesh(1, 1, device="cpu")
    assert mesh.shape == {"streams": 1, "time": 1}
    assert mesh.device == torch.device("cpu")
    grid = make_grid_mesh(2, 4, device="cpu")
    assert grid.devices == (torch.device("cpu"),) * 8
    assert not grid.multiproc and grid.local_streams() == [0, 1]
    with pytest.raises(ValueError,
                       match="needs 8 devices; this process has 2"):
        make_grid_mesh(2, 4, devices=["cpu", "cpu"])
    two = make_grid_mesh(1, 2, devices=["cpu", "cpu"])
    assert callable(sharded.make_multichip_step(two))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError,
                       match="needs 4 devices; this process has 2 .cuda."):
        make_grid_mesh(2, 2, device="cuda")


@pytest.mark.parametrize("asked, current, first", [
    ("cuda:1", 0, 1), ("cuda:0", 1, 0), ("cuda", 2, 2)])
def test_grid_mesh_starts_at_the_device_asked_for(monkeypatch, asked,
                                                  current, first):
    """A 1 x 1 grid is the card the caller named (a bare ``cuda``: the
    current one), not the process's first; the grid's devices are the
    process's cards, each once.  The card count is patched: no card is
    touched."""
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    assert make_grid_mesh(1, 1, device=asked).device == \
        torch.device("cuda", first)
    grid = make_grid_mesh(2, 2, device=asked)
    assert grid.devices[0] == torch.device("cuda", first)
    assert sorted(d.index for d in grid.devices) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="needs 8 devices; this process "
                                         "has 4"):
        make_grid_mesh(2, 4, device=asked)
