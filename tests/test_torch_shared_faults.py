"""Behaviours the port shares with the JAX package on purpose, each a
recorded fault of both (ROADMAP section 3, items 6-8): the port mirrors
the reference until a fix lands in both together.  Each test runs both
packages on the CPU on the same inputs, made from a seed with numpy,
and shows they behave alike."""

import numpy as np
import pytest

from gnuais_tpu.golden import encoder as E

from test_torch_iq import _modulate, _write_iq
from test_torch_timepar import SB, _assert_same_result, _session_capture
from test_torch_timepar_cli import _both, _noisy, _run


def test_session_position_past_int32_raises_in_both_packages():
    """The fault both packages share (ROADMAP section 3): a push whose
    held block ends past 2^31 samples raises OverflowError at the int32
    positions, in the JAX session and in the port's alike, before
    anything of the session changes."""
    from gnuais_tpu.parallel.mesh import make_grid_mesh as jax_mesh
    from gnuais_tpu.parallel.timepar import TimeParSession as JaxSession
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    block = _session_capture()[:SB][None, :]
    base = 2 ** 31 - SB
    for sess in (JaxSession(jax_mesh(1, 1), 1, SB),
                 TimeParSession(make_grid_mesh(1, 1, device="cpu"), 1, SB)):
        sess.restore({"_held": block, "_held_base": base,
                      "_prev_tail": np.zeros((1, 4096), np.int16),
                      "_base": base + SB, "_last_starts": None,
                      "_last_bad": None, "received": [0], "wrong_crc": [0],
                      "wrong_size": [0]})
        with pytest.raises(OverflowError):
            sess.push(block)
        assert sess._base == base + SB and sess.received == [0]


def test_session_drops_frames_past_its_slots_uncounted_in_both_packages():
    """A window of the 1 x 1 session holds at most ``frame_slots`` owned
    frames: the rest are dropped, and no counter of the session (received,
    wrong CRC, wrong size) shows them, in the JAX session and in the
    port's alike (ROADMAP section 3).  Busy traffic, 2 slots a window;
    with the default 32 every payload decodes."""
    from gnuais_tpu.parallel.mesh import make_grid_mesh as jax_mesh
    from gnuais_tpu.parallel.timepar import TimeParSession as JaxSession
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    from test_torch_timepar import _flat, _pushes, _run_session
    rng = np.random.default_rng(2)
    payloads = [E.random_payload(rng) for _ in range(12)]
    pushes, n_valid = _pushes(E.synthesize_capture(payloads, gap_bits=24))
    got = []
    for sess in (JaxSession(jax_mesh(1, 1), 1, SB, frame_slots=2),
                 TimeParSession(make_grid_mesh(1, 1, device="cpu"), 1, SB,
                                frame_slots=2)):
        frames = _flat(_run_session(sess, pushes, n_valid))
        got.append((frames, sess.received, sess.wrong_crc, sess.wrong_size))
    assert got[0] == got[1]
    frames, received, wrong_crc, wrong_size = got[1]
    assert received == [len(frames)] and len(frames) < len(payloads)
    assert (wrong_crc, wrong_size) == ([0], [0])
    roomy = TimeParSession(make_grid_mesh(1, 1, device="cpu"), 1, SB)
    assert len(_run_session(roomy, pushes, n_valid)) == len(payloads)


def _fleet_rows(n_rows, seed=20261016, block=49_152, variants=8):
    """Rows like chip_smoke.py's fleet block (an encoder capture of 8
    payloads a row, its bit grid on multiples of 5 samples within the
    row, the idle level after it held, noise 300), made with numpy.
    Returns (rows [n_rows, block] int16, the payloads of each row)."""
    from gnuais_tpu_torch import captures
    rng = np.random.default_rng(seed)
    rows, pays = [], []
    for r in range(n_rows):
        audio, payloads = captures.payload_capture(
            np.random.default_rng([seed, r % variants]), 8, gap_bits=64)
        row = np.full(block, audio[-1], np.int16)
        shift = 5 * (r // variants * 97)
        row[shift:shift + len(audio)] = audio
        rows.append(_noisy(row, rng, 300))
        pays.append([p.tobytes() for p in payloads])
    return np.stack(rows), pays


def test_lanes_lose_frames_after_transition_free_overlaps_in_both_packages():
    """The lanes' shared limit: rows laid end to end (lanes of one row
    each), every lane's lead overlap in the previous row's idle, which
    noise never takes across zero.  The cold DPLL starts at the grid
    phase PLL_INC*b mod 2^16, which drifts a 65536th of a bit per bit
    from a 5-sample grid, so after 10^5 samples it can sit too far from
    the row's grid for the preamble to pull it in: both packages lose
    the same frames, which the sequential chain decodes, and the CLI's
    envelope guard (constant runs only) lets such a capture through."""
    from gnuais_tpu.parallel import timepar as J
    from gnuais_tpu.runtime.pipeline import BatchPipeline
    from gnuais_tpu_torch.cli import _max_constant_run
    from gnuais_tpu_torch.parallel import timepar as T
    rows, pays = _fleet_rows(3)
    stream = rows.reshape(-1)
    want = [p for row in pays for p in row]
    seq = BatchPipeline(1, block_len=rows.shape[1], frame_slots=64)
    got_seq = [f.payload_bits[:f.bufferlen].tobytes()
               for row in rows for f in seq.process(row[None])[0]]
    assert got_seq == want
    mine = T.time_parallel_decode(stream, chunk_len=rows.shape[1],
                                  device="cpu")
    theirs = J.time_parallel_decode(stream, chunk_len=rows.shape[1])
    _assert_same_result(theirs, mine)
    got = [f.payload_bits[:f.bufferlen].tobytes() for f in mine.frames]
    assert len(got) < len(want) and set(got) <= set(want)
    assert _max_constant_run(stream) < T.DEFAULT_OVERLAP


def test_sequential_iq_reslices_reader_blocks_as_jax_does(tmp_path,
                                                          monkeypatch):
    """A behaviour both packages share (ROADMAP section 3): the
    sequential IQ path cuts each 65,536-frame reader block into
    1020-frame session blocks, so a 256-frame block follows every reader
    block and the A/B emission order of a longer stereo capture departs
    from the 1020-frame framing that the lanes keep.  The port's
    sequential IQ stdout equals the JAX CLI's, line for line, and holds
    each channel's lines in the lanes' order."""
    rng = np.random.default_rng(97)
    n = 70_000
    chans = []
    for lead in (64, 75):
        pays = [E.random_payload(rng) for _ in range(40)]
        a = E.synthesize_capture(pays, gap_bits=40, lead_in_bits=lead)
        chans.append(_noisy(np.resize(a, n), rng))
    iq = tmp_path / "long.iq"
    _write_iq(iq, [_modulate(c) for c in chans])
    conf = (f"soundchannels both\ninputformat iq\niqdecim 4\nbackend golden\n"
            f"soundinfile {iq}")
    out, _text, _c = _both(conf, monkeypatch)
    lanes = _run("jax", conf + "\nstreams 2", monkeypatch)[1]
    for ch in "AB":
        mine = [l for l in out.splitlines() if l.startswith(f"ch {ch} ")]
        assert mine == [l for l in lanes.splitlines()
                        if l.startswith(f"ch {ch} ")]
    assert out != lanes
