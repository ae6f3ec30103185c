"""Raw-IQ streams through the batch session (``runtime.batch.BatchSession``
with ``iq``) and ``--batch`` with an ``inputformat iq`` config, on the
CPU, against the benchmark's plain reference front end
(``portbench/reference/iq.py``) and the int16 path.

Four streams of two 4096-sample blocks, made from a seed: AIS frames
with noise, FM-modulated at the published 2.4 kHz peak deviation into
float32 I/Q at 4 x 48 kHz.  Limits, as the benchmark's ``frontend``
check has them: no sample off the reference's by more than 1 LSB, at
most one in 1000 off by 1 (an ``atan2`` or a sum that rounds in another
order moves a value across a half); on one device the two agree bit for
bit.  Decoding the session's own audio through the int16 session is
bitwise the same run.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnuais_tpu_torch import cli
from gnuais_tpu_torch.golden import encoder as E
from gnuais_tpu_torch.io.iq import IqStreamReader
from gnuais_tpu_torch.runtime import trace
from gnuais_tpu_torch.runtime.batch import BatchSession
from portbench import checks
from portbench.reference import iq as ref_iq

S, BL, DECIM = 4, 4096, 4
T = 2 * BL
NAMES = [f"s{i}" for i in range(S)]


def _audio(seed: int) -> np.ndarray:
    """int16 [S, T]: two AIS frames a stream, noise sigma 300."""
    rng = np.random.default_rng(seed)
    out = np.zeros((S, T), np.int16)
    for s in range(S):
        a = E.synthesize_capture([E.random_payload(rng) for _ in range(2)])
        a = np.clip(a + rng.normal(0, 300, len(a)), -32768, 32767)
        out[s, :min(T, len(a))] = a[:T]
    return out


def _modulate(audio: np.ndarray) -> np.ndarray:
    """int16 audio [..., n] -> float32 I/Q [2, ..., n x DECIM]: a level of
    8000 at a 2400-Hz deviation, phase-integrated in float64."""
    f = np.repeat(audio.astype(np.float64) / 8000 * 2400, DECIM, axis=-1)
    phase = 2 * np.pi * np.cumsum(f, axis=-1) / (48_000 * DECIM)
    return np.stack([np.cos(phase), np.sin(phase)]).astype(np.float32)


def _session(**kw):
    return BatchSession(NAMES, block_len=BL, frame_slots=16,
                        backend="fused", device="cpu", **kw)


def _recording(sess):
    """Keep each block that the session hands its pipeline."""
    seen, process = [], sess.pipe.process

    def rec(block):
        seen.append(block.clone() if isinstance(block, torch.Tensor)
                    else block.copy())
        return process(block)
    sess.pipe.process = rec
    return seen


@pytest.fixture(scope="module")
def one_shot():
    """The IQ session over both blocks in one call: its rails, the blocks
    it decoded and its result."""
    iq = _modulate(_audio(18))
    sess = _session(iq=True)
    seen = _recording(sess)
    res = sess.run([(iq[0, i], iq[1, i]) for i in range(S)])
    return iq, seen, res


def test_iq_session_audio_is_the_plain_references(one_shot):
    iq, seen, res = one_shot
    want, _ = ref_iq.frontend(torch.from_numpy(iq[0]),
                              torch.from_numpy(iq[1]),
                              ref_iq.start(S, "cpu"), DECIM)
    got = torch.cat(seen, dim=1)
    assert got.dtype == torch.int16 and got.shape == want.shape == (S, T)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int((diff > 1).sum()) == 0
    assert int((diff == 1).sum()) <= diff.numel() // 1000
    assert res.samples == S * T and len(res.lines) >= S


def test_iq_session_decodes_as_int16_and_the_plain_chain(one_shot):
    """The IQ session's messages, lines and counters equal the int16
    session's on its own audio, bitwise, and the plain reference chain's
    on the reference front end's audio."""
    iq, seen, res = one_shot
    audio = torch.cat(seen, dim=1).numpy()
    plain = _session().run([audio[i] for i in range(S)])
    assert res.lines == plain.lines and res.counters == plain.counters
    assert [m.nmea_sentences for m in res.messages] == \
        [m.nmea_sentences for m in plain.messages]
    ref_audio, _ = ref_iq.frontend(torch.from_numpy(iq[0]),
                                   torch.from_numpy(iq[1]),
                                   ref_iq.start(S, "cpu"), DECIM)
    for i, name in enumerate(NAMES):
        frames, counters = checks.plain_decode(ref_audio[i].numpy(), T)
        want = [f"[{name}] {m.stdout_line}"
                for m in checks.reference_messages(frames, "A")]
        assert [ln for ln in res.lines if ln.startswith(f"[{name}] ")] \
            == want
        assert res.counters[name] == counters


def test_iq_session_split_into_calls_equals_one_shot(one_shot):
    iq, seen, res = one_shot
    sess = _session(iq=True)
    split = _recording(sess)
    calls = [sess.run([(iq[0, i, lo:lo + BL * DECIM],
                        iq[1, i, lo:lo + BL * DECIM]) for i in range(S)])
             for lo in (0, BL * DECIM)]
    assert all(torch.equal(a, b) for a, b in zip(split, seen))
    assert torch.equal(sess.audio, seen[-1])
    assert sum((c.lines for c in calls), []) == res.lines
    assert calls[-1].counters == res.counters


def test_iq_session_short_streams_decode_as_int16_padded(one_shot):
    """Streams that end inside the last, short block: the IQ session's
    audio is zero past a stream's end, as the int16 session pads, so both
    decode alike (the front end is causal: the one-shot audio cut to a
    stream's length is its audio)."""
    iq, seen, _ = one_shot
    audio = torch.cat(seen, dim=1).numpy()
    lengths = (7000, 5000, 4500, 6004)
    sess = _session(iq=True)
    blocks = _recording(sess)
    res = sess.run([(iq[0, i, :n * DECIM], iq[1, i, :n * DECIM])
                    for i, n in enumerate(lengths)])
    assert [tuple(b.shape) for b in blocks] == [(S, BL), (S, 7000 - BL)]
    for i, n in enumerate(lengths):
        got = torch.cat(blocks, dim=1)[i].numpy()
        assert np.array_equal(got[:n], audio[i, :n]) and not got[n:].any()
    plain = _session().run([audio[i, :n] for i, n in enumerate(lengths)])
    assert res.lines == plain.lines and res.counters == plain.counters
    assert res.samples == plain.samples == S * 7000


def test_iq_session_spans_and_counters_under_a_profiler(one_shot):
    """The session's own spans and counters while a profiler records (the
    decode below it left out: a profiler slows its plain loops here)."""
    iq = one_shot[0]
    sess = _session(iq=True)
    sess.pipe.process = lambda block: [[] for _ in range(S)]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        sess.run([(iq[0, i], iq[1, i]) for i in range(S)])
    totals, counters = trace.totals(), trace.counters()
    trace.reset()
    for span in ("batch.assemble", "iq.upload", "iq.frontend",
                 "batch.deliver"):
        assert totals[span].calls == 2, span
    assert counters["iq.h2d_bytes"] == iq.nbytes
    assert counters["iq.samples"] == S * T * DECIM
    assert counters["batch.blocks"] == 2
    assert "batch.staged_pinned" not in counters      # no card


def test_iq_session_refuses_unequal_or_partial_rails():
    sess = _session(iq=True)
    z = np.zeros(BL * DECIM, np.float32)
    with pytest.raises(ValueError):
        sess.run([(z, z[:-DECIM])] + [(z, z)] * (S - 1))
    with pytest.raises(ValueError):
        sess.run([(z[:-1], z[:-1])] + [(z, z)] * (S - 1))


def test_cli_batch_takes_iq_through_its_config(tmp_path, capsys):
    """``--batch`` with ``inputformat iq`` (stereo files, channel A
    decoded) prints what ``--batch`` prints of the int16 files of the
    front end's audio of channel A."""
    a, b = _audio(19)[:2], _audio(20)[:2]
    iq_dir, s16_dir = tmp_path / "iq", tmp_path / "s16"
    iq_dir.mkdir()
    s16_dir.mkdir()
    conf = tmp_path / "iq.conf"
    conf.write_text("inputformat iq\niqdecim 4\nsoundchannels both\n")
    paths = {"iq": [], "s16": []}
    for k in range(2):
        rails = _modulate(np.stack([a[k], b[k]]))     # [2, ch, n]
        frames = np.stack([rails[0], rails[1]], axis=-1).transpose(1, 0, 2)
        path = iq_dir / f"cap{k}.raw"
        np.ascontiguousarray(frames, dtype="<f4").tofile(path)
        chan_a = IqStreamReader(str(path), channels=2, decim=DECIM,
                                device="cpu").read_all()[0::2]
        (s16_dir / f"cap{k}.raw").write_bytes(chan_a.astype("<i2")
                                             .tobytes())
        paths["iq"].append(str(path))
        paths["s16"].append(str(s16_dir / f"cap{k}.raw"))
    out = {}
    for kind, extra in (("iq", ["-c", str(conf)]), ("s16", [])):
        assert cli.main(extra + ["--batch", *paths[kind], "--device", "cpu",
                                 "--backend", "fused"]) == 0
        out[kind] = capsys.readouterr().out
    assert out["iq"] == out["s16"] and out["iq"].count("\n") >= 2
