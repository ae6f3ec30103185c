"""The port's IQ front end (``gnuais_tpu_torch.ops.discriminator``,
``gnuais_tpu_torch.io.iq``) against the JAX package's on the CPU, on the
same inputs made from a seed with numpy.

Tolerances: the products of the discriminator and the whole decimator
are bitwise equal to JAX's; ``atan2`` is not (XLA's float32 atan2 and
torch's differ in the last bits, ROADMAP section 3), so the
discriminator's float output is held within 8 float32 ulps plus 2^-14
absolute, and the int16 audio of whole captures to at most
``MAX_PLUS_MINUS_ONE`` samples that differ, by 1 at most; the decoded
frames are equal.  Within the port, block-wise equals one-shot and a
resume equals the uninterrupted stream bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

from gnuais_tpu.golden import encoder as E

DECIM = 4
# int16 samples of a capture allowed to differ (by 1) from the JAX
# package's audio: the rounding of an atan2 that differs in its last
# bit flips a sample only when it lies within an ulp of a half
MAX_PLUS_MINUS_ONE = 8


def _modulate(audio: np.ndarray, decim: int = DECIM) -> np.ndarray:
    """FM-modulate int16 audio into complex64 baseband IQ at 48 kHz *
    decim (tests/test_iq_streaming.py's modulator)."""
    x = np.repeat(audio.astype(np.float64) / 32767.0, decim)
    phase = 2 * np.pi * np.cumsum(x * 2400.0) / (48000.0 * decim)
    return np.exp(1j * phase).astype(np.complex64)


def _write_iq(path, chans):
    """complex64 channels -> raw float32 [I0 Q0 I1 Q1 ...] frames."""
    n = min(len(c) for c in chans)
    out = np.empty((n, len(chans), 2), dtype="<f4")
    for i, c in enumerate(chans):
        out[:, i, 0] = c[:n].real
        out[:, i, 1] = c[:n].imag
    out.tofile(path)
    return n


def _noisy(rng, n_payloads, **kw):
    audio = E.synthesize_capture(
        [E.random_payload(rng) for _ in range(n_payloads)], **kw)
    return np.clip(audio + rng.normal(0, 300, len(audio)), -32768,
                   32767).astype(np.int16)


@pytest.fixture(scope="module")
def stereo_iq(tmp_path_factory):
    """A stereo IQ capture (6 payloads a channel, noise 300), its path."""
    rng = np.random.default_rng(5)
    a = _noisy(rng, 6, gap_bits=200)
    b = _noisy(rng, 6, gap_bits=200, lead_in_bits=96)
    p = tmp_path_factory.mktemp("iq") / "st.iq"
    _write_iq(p, [_modulate(a), _modulate(b)])
    return p


def _assert_close_audio(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype == np.int16
    d = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(d).max(initial=0) <= 1
    assert np.count_nonzero(d) <= MAX_PLUS_MINUS_ONE


def test_design_decim_fir_is_the_same():
    from gnuais_tpu.ops import discriminator as J
    from gnuais_tpu_torch.ops import discriminator as T
    for decim in (3, 4, 5, 10):
        assert np.array_equal(J.design_decim_fir(decim),
                              T.design_decim_fir(decim))


def test_fm_discriminate_against_jax():
    import jax.numpy as jnp
    from gnuais_tpu.ops import discriminator as J
    from gnuais_tpu_torch.ops import discriminator as T
    rng = np.random.default_rng(11)
    i, q = rng.standard_normal((2, 3, 20000)).astype(np.float32)
    li, lq = rng.standard_normal((2, 3)).astype(np.float32)
    ja, jli, jlq = J.fm_discriminate(*map(jnp.asarray, (i, q, li, lq)))
    ta, tli, tlq = T.fm_discriminate(*map(torch.from_numpy, (i, q, li, lq)))
    ja = np.asarray(ja)
    ta = ta.numpy()
    assert ta.dtype == np.float32 and ta.shape == ja.shape
    tol = 8 * np.spacing(np.abs(ja)) + 2.0 ** -14
    assert (np.abs(ta - ja) <= tol).all()
    assert np.array_equal(tli.numpy(), np.asarray(jli))
    assert np.array_equal(tlq.numpy(), np.asarray(jlq))


@pytest.mark.parametrize("decim", [4, 5])
def test_decimate_bitwise_and_chunked(decim):
    """The decimator equals JAX's bit for bit, chunked (16384-sample
    pieces on the decimation grid) and one-shot alike."""
    import jax.numpy as jnp
    from gnuais_tpu.ops import discriminator as J
    from gnuais_tpu_torch.ops import discriminator as T
    rng = np.random.default_rng(3 + decim)
    t = decim * 8192
    x = (3000 * rng.standard_normal((2, t))).astype(np.float32)
    hist = rng.standard_normal((2, 64)).astype(np.float32)
    taps = T.design_decim_fir(decim)
    ref, href = J.decimate(jnp.asarray(x), jnp.asarray(hist),
                           jnp.asarray(taps), decim, chunk=t)
    for chunk in (t, 16384):
        out, hout = T.decimate(torch.from_numpy(x), torch.from_numpy(hist),
                               torch.from_numpy(taps), decim, chunk=chunk)
        assert out.shape == (2, t // decim)
        assert np.array_equal(out.numpy(), np.asarray(ref)), chunk
        assert np.array_equal(hout.numpy(), np.asarray(href)), chunk


def test_iq_to_int16_audio_against_jax():
    import jax.numpy as jnp
    from gnuais_tpu.ops import discriminator as J
    from gnuais_tpu_torch.ops import discriminator as T
    rng = np.random.default_rng(17)
    a, b = (_modulate(_noisy(rng, 2)) for _ in range(2))
    n = min(len(a), len(b)) // DECIM * DECIM
    iq = np.stack([a[:n], b[:n]])
    i = np.ascontiguousarray(iq.real, dtype=np.float32)
    q = np.ascontiguousarray(iq.imag, dtype=np.float32)
    taps = T.design_decim_fir(DECIM)
    ja, jst = J.iq_to_int16_audio(jnp.asarray(i), jnp.asarray(q),
                                  J.init_iq(2), jnp.asarray(taps), DECIM)
    ta, tst = T.iq_to_int16_audio(torch.from_numpy(i), torch.from_numpy(q),
                                  T.init_iq(2, device="cpu"),
                                  torch.from_numpy(taps), DECIM)
    _assert_close_audio(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tst.last_i.numpy(), np.asarray(jst.last_i))
    jh = np.asarray(jst.fir_history)
    assert np.allclose(tst.fir_history.numpy(), jh, rtol=2e-6, atol=2e-3)


def test_file_reader_blocks_equal_one_shot_and_jax(stereo_iq):
    """The port's reader at an odd block size equals its one-shot front
    end bit for bit, and the JAX package's reader within the stated
    ±1 count; both decode the same frames."""
    from gnuais_tpu.io.iq import IqStreamReader as JaxReader
    from gnuais_tpu_torch.golden.model import GoldenReceiver
    from gnuais_tpu_torch.io.iq import IqStreamReader
    from gnuais_tpu_torch.ops import discriminator as T
    reader = IqStreamReader(stereo_iq, channels=2, decim=DECIM,
                            block_frames=1777, device="cpu")
    streamed = reader.read_all()
    m = reader.n_frames * DECIM
    raw = np.fromfile(stereo_iq, dtype="<f4")[:m * 4].reshape(m, 2, 2)
    oneshot, _ = T.iq_to_int16_audio(
        torch.from_numpy(np.ascontiguousarray(raw[:, :, 0].T)),
        torch.from_numpy(np.ascontiguousarray(raw[:, :, 1].T)),
        T.init_iq(2, device="cpu"),
        torch.from_numpy(T.design_decim_fir(DECIM)), DECIM)
    inter = np.empty(oneshot.shape[1] * 2, np.int16)
    inter[0::2], inter[1::2] = oneshot.numpy()
    assert np.array_equal(streamed, inter)
    jax_audio = JaxReader(stereo_iq, channels=2, decim=DECIM,
                          block_frames=4096).read_all()
    _assert_close_audio(streamed, jax_audio)
    for ch in (0, 1):
        mine = GoldenReceiver("A").run_block(streamed[ch::2])
        theirs = GoldenReceiver("A").run_block(jax_audio[ch::2])
        assert len(mine) >= 5
        assert [f.payload_bits[:f.bufferlen].tobytes() for f in mine] == \
            [f.payload_bits[:f.bufferlen].tobytes() for f in theirs]


def test_resume_rebuilds_the_carry_exactly(tmp_path):
    """``_state_at``: a resume at any output frame equals the tail of the
    uninterrupted stream bit for bit (decim 5 too), and its carry is the
    JAX package's within the discriminator's tolerance."""
    from gnuais_tpu.io.iq import IqStreamReader as JaxReader
    from gnuais_tpu_torch.io.iq import IqStreamReader
    rng = np.random.default_rng(9)
    a = _noisy(rng, 2)
    for decim in (DECIM, 5):
        p = tmp_path / f"m{decim}.iq"
        _write_iq(p, [_modulate(a, decim)])
        reader = IqStreamReader(p, channels=1, decim=decim,
                                block_frames=4096, device="cpu")
        jreader = JaxReader(p, channels=1, decim=decim, block_frames=4096)
        full = reader.read_all()
        assert reader.n_frames > 4000
        for off in (1, 17, 63, 64, 65, 4000, reader.n_frames + 5):
            assert np.array_equal(reader.read_all(skip_frames=off),
                                  full[off:]), (decim, off)
            if off > reader.n_frames:
                continue
            st, jst = reader._state_at(off), jreader._state_at(off)
            for mine, theirs in zip(st, jst):
                theirs = np.asarray(theirs)
                tol = 8 * np.spacing(np.abs(theirs)) + 2.0 ** -14
                assert (np.abs(mine.numpy() - theirs) <= tol).all(), off


def test_live_reader_equals_file_reader(stereo_iq, tmp_path):
    """The same IQ bytes through a FIFO give the file reader's audio bit
    for bit, also when resumed (the skipped frames evolve the carry);
    a trailing partial frame is dropped like fread's whole items."""
    from gnuais_tpu_torch.io.iq import IqLiveReader, IqStreamReader
    want = IqStreamReader(stereo_iq, channels=2, decim=DECIM,
                          block_frames=3000, device="cpu").read_all()
    raw = stereo_iq.read_bytes()
    for skip in (0, 5000):
        fifo = tmp_path / f"live{skip}.fifo"
        os.mkfifo(fifo)

        def feed():
            with open(fifo, "wb") as f:
                for o in range(0, len(raw), 65536 + 12):
                    f.write(raw[o:o + 65536 + 12])
                f.write(b"\0" * 12)          # a partial frame at EOF

        t = threading.Thread(target=feed)
        t.start()
        try:
            live = IqLiveReader(str(fifo), channels=2, decim=DECIM,
                                block_frames=3000, device="cpu")
            got = live.read_all(skip_frames=skip)
            live.close()
        finally:
            t.join(timeout=30)
        assert np.array_equal(got, want[2 * skip:]), skip


def test_iq_state_crosses_packages(stereo_iq):
    """``convert.iq_state_to_numpy``/``iq_state_from_numpy``: the JAX
    reader's carry at a resume point continues in the port, the port's
    in the JAX package, and each side decodes the same frames after it
    as the other."""
    import jax.numpy as jnp
    from gnuais_tpu.io.iq import IqStreamReader as JaxReader
    from gnuais_tpu.ops.discriminator import IqState as JaxIqState
    from gnuais_tpu_torch import convert
    from gnuais_tpu_torch.golden.model import GoldenReceiver
    from gnuais_tpu_torch.io.iq import IqStreamReader, _iq_step
    off = 4321
    mine = IqStreamReader(stereo_iq, channels=2, decim=DECIM,
                          block_frames=2048, device="cpu")
    theirs = JaxReader(stereo_iq, channels=2, decim=DECIM,
                       block_frames=2048)

    def jax_blocks(state):
        f = off
        while f < theirs.n_frames:
            f1 = min(f + theirs.block_frames, theirs.n_frames)
            ii, qq = theirs._iq_slice(f, f1)
            a, state = theirs._step(jnp.asarray(ii), jnp.asarray(qq), state)
            a = np.asarray(a)
            out = np.empty(a.shape[1] * 2, np.int16)
            out[0::2], out[1::2] = a
            yield out
            f = f1

    def port_blocks(state):
        step = _iq_step(DECIM, mine.NTAPS, torch.device("cpu"))
        for f in range(off, mine.n_frames, mine.block_frames):
            f1 = min(f + mine.block_frames, mine.n_frames)
            a, state = step(*mine._iq_slice(f, f1), state)
            out = np.empty(a.shape[1] * 2, np.int16)
            out[0::2], out[1::2] = a
            yield out

    # the JAX carry into the port, the port's carry into the JAX package
    jst = convert.iq_state_from_numpy(
        [np.asarray(v) for v in theirs._state_at(off)], "cpu")
    into_port = np.concatenate(list(port_blocks(jst)))
    leaves = convert.iq_state_to_numpy(mine._state_at(off))
    assert [a.dtype for a in leaves] == [np.float32] * 3
    into_jax = np.concatenate(list(jax_blocks(
        JaxIqState(*map(jnp.asarray, leaves)))))
    own = mine.read_all(skip_frames=off)
    _assert_close_audio(into_port, own)
    _assert_close_audio(into_jax, own)
    for ch in (0, 1):
        frames = [[f.payload_bits[:f.bufferlen].tobytes()
                   for f in GoldenReceiver("A").run_block(x[ch::2])]
                  for x in (own, into_port, into_jax)]
        assert frames[0] and frames[0] == frames[1] == frames[2]
