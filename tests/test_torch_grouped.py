"""The port's ``GroupedTimeParSession`` (``gnuais_tpu_torch.parallel.
timepar``) against the JAX package's on the CPU: the JAX session on
conftest's 8 virtual CPU devices, the port's on 8 logical shards (kernel
B2's plain version on each), both on a 4 x 2 grid with 3072-sample
shards, a 1280-sample overlap and a 3072-sample extension (longer than
the longest frame), on the same captures made from a seed with
numpy.  Mono (one channel in 4 row segments) and stereo (two
channels in 2 each) over two full pushes and a short final flush (the
row-padded fallback); frames, starts, ends, counters and peaks equal.
A snapshot taken after the first decoded push in either package
restores into the other and continues identically."""

import numpy as np
import pytest
import torch

import jax

from gnuais_tpu.golden import encoder as E

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
O = 1280
EXT = T_LOC = 3072
SB_ROW = 2 * T_LOC              # a row segment: the grid's 2 time shards


def _capture(n_ch: int, seed: int):
    """n_ch channels of noisy traffic, two full pushes and a tail shorter
    than a row segment; returns (pushes [n_ch, super_block] each, the
    final push's valid samples, the super-block)."""
    group = 4 // n_ch
    sb = group * SB_ROW
    rng = np.random.default_rng(seed)
    n = 2 * sb + 1700
    x = np.zeros((n_ch, n), np.int16)
    for c in range(n_ch):
        audio = E.synthesize_capture(
            [E.random_payload(rng) for _ in range(40)], gap_bits=60 + 9 * c,
            lead_in_bits=50 + 31 * c)
        m = min(len(audio), n)
        x[c, :m] = audio[:m]
    x = np.clip(x + rng.normal(0, 250, x.shape), -32768,
                32767).astype(np.int16)
    pushes = [x[:, i * sb:(i + 1) * sb] for i in range(2)]
    pushes.append(np.pad(x[:, 2 * sb:], ((0, 0), (0, 3 * sb - n))))
    return pushes, n - 2 * sb, sb


def _session(pkg, n_ch):
    if pkg == "torch":
        from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
        from gnuais_tpu_torch.parallel.timepar import GroupedTimeParSession
        mesh = make_grid_mesh(4, 2, device="cpu")
    else:
        from gnuais_tpu.parallel.mesh import make_grid_mesh
        from gnuais_tpu.parallel.timepar import GroupedTimeParSession
        mesh = make_grid_mesh(4, 2)
    return GroupedTimeParSession(mesh, n_ch, 4 // n_ch, SB_ROW,
                                 frame_slots=16, overlap=O, extension=EXT)


def _flat(per_channel):
    return [[(s, e, f.payload_bits[:f.bufferlen].tobytes())
             for s, e, f in lst] for lst in per_channel]


def _run(sess, pushes, n_valid, got=None):
    got = got or [[] for _ in range(sess.n_channels)]
    for p in pushes:
        out = sess.push(p)
        if out:
            for c, lst in enumerate(_flat(out)):
                got[c] += lst
    for c, lst in enumerate(_flat(sess.flush(n_valid=n_valid))):
        got[c] += lst
    return got


def _counters(sess):
    return (sess.received, sess.wrong_crc, sess.wrong_size, sess.last_peak)


@needs_mesh
@pytest.mark.parametrize("n_ch", [1, 2], ids=["mono", "stereo"])
def test_grouped_session_matches_jax(n_ch):
    pushes, n_valid, sb = _capture(n_ch, 61 + n_ch)
    res = {}
    for pkg in ("jax", "torch"):
        sess = _session(pkg, n_ch)
        assert sess.super_block == sb and sess.n_rows == 4
        res[pkg] = _run(sess, pushes, n_valid), _counters(sess)
    assert res["torch"] == res["jax"]
    got, (received, _crc, _size, _peak) = res["torch"]
    assert received == [len(g) for g in got]
    assert all(len(g) >= 12 * (3 - n_ch) for g in got)
    # frames across the seams of the row segments and of the pushes
    seams = [k * SB_ROW for k in range(1, 3 * sb // SB_ROW)]
    assert any(st < seam <= en for g in got for st, en, _b in g
               for seam in seams)


@needs_mesh
def test_grouped_snapshot_crosses_packages():
    """After the first decoded push, a snapshot (numpy arrays and Python
    values under the JAX class's keys) restores into a new session of the
    other package, which continues as an uninterrupted session does."""
    from gnuais_tpu.parallel.timepar import GroupedTimeParSession as J
    from gnuais_tpu_torch import convert
    pushes, n_valid, _sb = _capture(1, 67)
    ref = _session("jax", 1)
    want = _run(ref, pushes, n_valid)
    for first, second in (("torch", "jax"), ("jax", "torch")):
        a = _session(first, 1)
        head = [[]]
        for p in pushes[:2]:
            out = a.push(p)
            if out:
                head[0] += _flat(out)[0]
        snap = convert.snapshot_to_numpy(a.snapshot())
        assert set(snap) == set(J._SNAP_KEYS)
        assert not any(isinstance(v, torch.Tensor) for v in snap.values())
        b = _session(second, 1)
        b.restore(snap)
        got = _run(b, pushes[2:], n_valid, got=head)
        assert got == want, (first, second)
        assert _counters(b)[:3] == _counters(ref)[:3]


def test_stereo_cli_meshshape_4_2_matches_jax(tmp_path, monkeypatch):
    """The CLI with two channels on a 4 x 2 grid (2 row segments each)
    against the JAX CLI in this process: stdout (the A/B emission order)
    and counters equal, and equal to the sequential session's."""
    from test_torch_mesh_cli import _against_sequential, _stereo
    cap = _stereo(tmp_path, np.random.default_rng(73), 6, 6)
    seq = f"soundchannels both\nsoundinfile {cap}"
    _out, text, counters = _against_sequential(
        seq + "\nmeshshape 4 2\ntimeparblock 4096", seq, monkeypatch)
    assert "2 channel row(s) x 2 row segments" in text
    assert counters == {"A": (6, 0, 0), "B": (6, 0, 0)}


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_grouped_cli_checkpoint_resumes_in_the_other_package(
        first, tmp_path, monkeypatch):
    """A ``meshshape 4 2`` decode of a mono capture (the grouped session)
    with ``--checkpoint`` crashes after two pushes in one package; the
    other resumes from its ``.mesh.npz``: the lines before the snapshot
    and the resumed run's are the uninterrupted run's, and the counters
    continue."""
    from test_torch_timepar_cli import _crashing, _noisy, _run
    rng = np.random.default_rng(89)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(20)],
                                 gap_bits=500)
    cap = tmp_path / "cap.raw"
    _noisy(audio, rng).tofile(cap)
    assert 2 * 32768 < len(audio) < 3 * 32768
    conf = (f"soundchannels mono\nmeshshape 4 2\ntimeparblock 4096\n"
            f"soundinfile {cap}")
    _rc, want, _t, c_want = _run("jax", conf, monkeypatch)
    ck = dict(checkpoint=str(tmp_path / "state"), checkpoint_every=1)
    with pytest.raises(RuntimeError, match="injected crash"):
        _run(first, conf, monkeypatch, block_iter=_crashing(16), **ck)
    data = np.load(tmp_path / "state.mesh.npz", allow_pickle=True)
    meta = data["meta"].item()
    assert meta["pushed"] == 2 and meta["layout"] == [4, 2, 32768, 1, 1]
    assert not any(type(v).__module__.startswith(("torch", "jax"))
                   for v in data["sess"].item().values())
    second = "torch" if first == "jax" else "jax"
    rc, out, text, counters = _run(second, conf, monkeypatch, **ck)
    assert rc == 0, text[-800:]
    assert "Resuming mesh decode" in text
    lines = want.splitlines()
    assert lines[:meta["emitted_lines"]] + out.splitlines() == lines
    assert counters == c_want
    assert not (tmp_path / "state.mesh.npz").exists()
