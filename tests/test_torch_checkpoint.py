"""Checkpoints across the package boundary (``runtime/checkpoint``): the
port writes the JAX package's npz format and reads it back, so a carry
saved by either package resumes in the other bitwise, and a
``--checkpoint`` run of either CLI on a prefix of a capture resumes in
the other CLI with exactly the lines of one uninterrupted JAX run,
multipart sentences (whose NMEA seqnr comes back from the checkpoint's
``extra``) included.  The CLIs broadcast to a recorder, not to the
default NMEA socket path that other tests of a parallel run bind."""

import jax
import numpy as np
import pytest

from gnuais_tpu import cli as jcli
from gnuais_tpu.golden import encoder as E
from gnuais_tpu.runtime import checkpoint as jckpt
from gnuais_tpu.runtime.pipeline import BatchPipeline as JaxPipeline
from gnuais_tpu_torch import cli as tcli
from gnuais_tpu_torch.convert import carry_to_numpy
from gnuais_tpu_torch.runtime import checkpoint as tckpt
from gnuais_tpu_torch.runtime.pipeline import BatchPipeline

from test_torch_cli import Sentences

BL = 1024


def _blocks(seed, s, n_blocks):
    """[s, n_blocks * BL] of encoder captures (one per stream) with
    noise, so that the carry holds frames in flight at every seam."""
    rng = np.random.default_rng(seed)
    out = np.zeros((s, n_blocks * BL), np.int16)
    for i in range(s):
        a = E.synthesize_capture([E.random_payload(rng) for _ in range(3)],
                                 gap_bits=30)[: n_blocks * BL]
        out[i, :len(a)] = a
    return out + rng.integers(-200, 200, out.shape).astype(np.int16)


def _payloads(per_stream):
    return [[f.payload_bits[:f.bufferlen].tobytes() for f in lst]
            for lst in per_stream]


def _jax_leaves(pipe):
    return [np.asarray(x) for x in jax.tree.leaves(pipe.carry)]


def _same_leaves(a, b):
    assert len(a) == len(b) == 13
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_carry_crosses_packages_bitwise(tmp_path, saver):
    x = _blocks(5, 3, 4)
    jp = JaxPipeline(3, block_len=BL, frame_slots=8)
    tp = BatchPipeline(3, block_len=BL, frame_slots=8, device="cpu")
    for b in range(2):
        jp.process(x[:, b * BL:(b + 1) * BL])
        tp.process(x[:, b * BL:(b + 1) * BL])
    path = tmp_path / "c.npz"
    if saver == "jax":
        jckpt.save_pipeline(path, jp, 2 * BL, extra={"seqnr": 7})
        resumed = BatchPipeline(3, block_len=BL, frame_slots=8, device="cpu")
        off, extra = tckpt.restore_pipeline(path, resumed)
        _same_leaves(_jax_leaves(jp), carry_to_numpy(resumed.carry))
        other = jp
    else:
        tckpt.save_pipeline(path, tp, 2 * BL, extra={"seqnr": 7})
        resumed = JaxPipeline(3, block_len=BL, frame_slots=8)
        off, extra = jckpt.restore_pipeline(path, resumed)
        _same_leaves(carry_to_numpy(tp.carry), _jax_leaves(resumed))
        other = tp
    assert (off, extra) == (2 * BL, {"seqnr": 7})
    assert [vars(c) for c in resumed.counters] == \
        [vars(c) for c in other.counters]
    # the same npz keys and leaf dtypes whichever package wrote them
    keys = sorted(np.load(path).files)
    assert keys == sorted([f"leaf_{i}" for i in range(13)] + ["__meta__"])
    # and the resumed pipeline decodes the rest like the saver
    for b in range(2, 4):
        blk = x[:, b * BL:(b + 1) * BL]
        assert _payloads(resumed.process(blk)) == _payloads(other.process(blk))
    assert [vars(c) for c in resumed.counters] == \
        [vars(c) for c in other.counters]


def test_load_rejects_another_stream_count(tmp_path):
    tp = BatchPipeline(3, block_len=BL, frame_slots=8, device="cpu")
    path = tmp_path / "c.npz"
    tckpt.save_pipeline(path, tp, 0)
    with pytest.raises(ValueError, match="stream count"):
        tckpt.restore_pipeline(
            path, BatchPipeline(4, block_len=BL, frame_slots=8, device="cpu"))
    jckpt.save_pipeline(path, JaxPipeline(2, block_len=BL), 0)
    with pytest.raises(ValueError, match="stream count"):
        tckpt.load_carry(path, 3, "cpu")


def _multipart_capture(tmp_path):
    """Seven messages, three of them two-sentence (type 5), with the
    cut between the first two of those."""
    rng = np.random.default_rng(9)
    pays = [E.make_type5(257099999), E.random_payload(rng, 1),
            E.make_type5(311000001, name="SECOND"), E.random_payload(rng, 18),
            E.random_payload(rng, 3), E.make_type5(257012345, dest="OSLO"),
            E.random_payload(rng, 1)]
    audio = E.synthesize_capture(pays, gap_bits=64)
    full = tmp_path / "full.raw"
    np.asarray(audio, dtype="<i2").tofile(full)
    cut = (len(audio) // 3 // 1020) * 1020 + 500
    part = tmp_path / "part.raw"
    np.asarray(audio[:cut], dtype="<i2").tofile(part)
    conf = tmp_path / "c.conf"
    conf.write_text("backend exact\n")
    return conf, full, part


def _run(main, conf, cap, capsys, extra=()):
    rc = main(["-c", str(conf), "-l", str(cap), "-e", "err", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    return out.splitlines()


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_cli_checkpoint_resumes_in_the_other_package(tmp_path, capsys,
                                                     monkeypatch, first):
    for cli in (jcli, tcli):
        monkeypatch.setattr(cli, "NmeaSocketServer", Sentences)
    conf, full, part = _multipart_capture(tmp_path)
    want = _run(jcli.main, conf, full, capsys)
    assert len(want) == 7
    assert sum(",2,2," in line for line in want) >= 3
    port = lambda argv: tcli.main(["--device", "cpu", *argv])  # noqa: E731
    mains = {"jax": jcli.main, "torch": port}
    second = "torch" if first == "jax" else "jax"
    ck = ["--checkpoint", str(tmp_path / "state")]
    got = _run(mains[first], conf, part, capsys, ck)
    rest = _run(mains[second], conf, full, capsys, ck)
    # a multipart sentence on each side of the seam
    assert any(",2,2," in line for line in got)
    assert any(",2,2," in line for line in rest)
    assert got + rest == want
