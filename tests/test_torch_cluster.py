"""The port's cluster (``gnuais_tpu_torch.parallel.cluster``) on the
CPU, against the JAX package's: the planning helpers in one process
(``plan_mesh_axes``, ``make_cluster_mesh``, ``local_stream_rows``,
``global_counter_sum``); two processes joined over gloo on this host,
each with 4 logical CPU shards of one 8-shard grid, running the
stream-sharded step on its own rows (mirroring
``tests/test_multihost.py``) and the streams x time step on a 1 x 8 grid
whose time row spans both processes (the halos between shards 3 and 4
cross them), equal to the step in one process; and the command line with
``--cluster`` in two processes on a stereo capture (mirroring
``tests/test_cluster.py``): rank 0's stdout is the sequential run's,
rank 1's is empty, both ranks' counters equal it.  Every spawned
process is killed if the pair outlives its time limit."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnuais_tpu.golden import encoder as E

REPO = Path(__file__).resolve().parent.parent


def test_plan_mesh_axes_matches_jax():
    from gnuais_tpu.parallel import cluster as J
    from gnuais_tpu_torch.parallel.cluster import plan_mesh_axes
    for args in ((8, 4, 1), (8, 4, 2), (8, 4, 4), (8, 8, 8)):
        assert plan_mesh_axes(*args) == J.plan_mesh_axes(*args)
    for args in ((8, 4, 8), (6, 4, 4)):     # across hosts; not divisible
        with pytest.raises(ValueError):
            plan_mesh_axes(*args)
        with pytest.raises(ValueError):
            J.plan_mesh_axes(*args)


def test_cluster_mesh_rows_and_counters_in_one_process():
    from gnuais_tpu_torch.parallel import cluster
    assert cluster.process_count() == 1 and cluster.process_index() == 0
    mesh = cluster.make_cluster_mesh(
        time_shards=2, devices=cluster.local_devices("cpu", 8))
    assert mesh.shape == {"streams": 4, "time": 2}
    assert not mesh.multiproc and mesh.local_streams() == [0, 1, 2, 3]
    assert cluster.local_stream_rows(mesh, 64) == slice(0, 64)
    grid = cluster.make_cluster_mesh(2, streams=2, device="cpu",
                                     devices=["cpu"] * 4)
    assert grid.shape == {"streams": 2, "time": 2}
    with pytest.raises(ValueError, match="needs 6 devices"):
        cluster.make_cluster_mesh(3, streams=2, devices=["cpu"] * 4)
    x = np.array([1, 2, 3])
    assert np.array_equal(cluster.global_counter_sum(x), x)
    cluster.initialize(cluster.ClusterConfig("127.0.0.1:1", 1, 0))
    assert cluster.process_count() == 1     # one process joins no group


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([path] if path else [])))


def _pair(argv_of_rank, cwd, timeout=240):
    """Two processes, rank 0 and 1, started together; both are killed if
    either outlives ``timeout``.  Returns [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(argv_of_rank(r), cwd=cwd, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


# one rank of the two-process steps: 4 logical CPU shards a process
_WORKER = r'''
import sys
import numpy as np
import torch
from gnuais_tpu_torch.golden import encoder as E
from gnuais_tpu_torch.parallel import cluster
from gnuais_tpu_torch.parallel import mesh as M
from gnuais_tpu_torch.parallel import sharded as S
from gnuais_tpu_torch.runtime import pipeline as pl

rank, coord = int(sys.argv[1]), sys.argv[2]
cluster.initialize(cluster.ClusterConfig(coord, 2, rank))
assert cluster.process_count() == 2 and cluster.process_index() == rank
mesh = cluster.make_cluster_mesh(devices=cluster.local_devices("cpu", 4))
assert mesh.shape == {"streams": 8, "time": 1} and mesh.multiproc
n_streams, t = 8, 4096
rows = cluster.local_stream_rows(mesh, n_streams)
assert rows == slice(rank * 4, rank * 4 + 4), rows


def stream_audio(i):
    return E.synthesize_capture(
        [E.make_type123(1, 200000000 + i, 10.0 + i, 20.0 + i),
         E.make_type18(300000000 + i, -10.0 - i, -20.0 - i)],
        gap_bits=48, lead_in_bits=64 + 8 * i)


# host-local ingest: every process could make every stream, but feeds
# only its own rows, and drains only them
local = np.zeros((4, t), dtype=np.int16)
for k, i in enumerate(range(rows.start, rows.stop)):
    a = stream_audio(i)
    local[k, :len(a)] = a
step = S.make_sharded_decode(mesh, frame_slots=8, fused_pipeline=True)
_carry, frames, _peak = step(local, t, pl.init_carry(4, "cpu"))
counts = frames.count.tolist()
assert counts == [2] * 4, counts
from gnuais_tpu_torch.ais.bits import henten, pad_payload
mmsis = [henten(8, 30, pad_payload(f.payload_bits))
         for per in pl.extract_frames(frames) for f in per]
want = [m for i in range(rows.start, rows.stop)
        for m in (200000000 + i, 300000000 + i)]
assert mmsis == want, (mmsis, want)
total = cluster.global_counter_sum(np.array([sum(counts)]))
assert int(total[0]) == 16, total

# a 1 x 8 grid: time shards 0-3 here on rank 0, 4-7 on rank 1
grid = cluster.make_cluster_mesh(8, streams=1,
                                devices=cluster.local_devices("cpu", 4))
assert grid.shape == {"streams": 1, "time": 8}
o = e = t_loc = 1280
x = np.zeros((2, 8 * t_loc), np.int16)
rng = np.random.default_rng(3)
for r in range(2):
    a = E.synthesize_capture([E.random_payload(rng) for _ in range(8)],
                             gap_bits=40, lead_in_bits=4 * t_loc // 5 - 260)
    x[r, :min(len(a), x.shape[1])] = a[:x.shape[1]]
x = np.clip(x + rng.normal(0, 250, x.shape), -32768, 32767).astype(np.int16)
args = (x, x.shape[1], 0, np.zeros((2, o), np.int16),
        np.zeros((2, e), np.int16))
tp = S.make_multichip_step(grid, frame_slots=8, overlap=o,
                           extension=e)(*args)
one = S.make_multichip_step(M.make_grid_mesh(1, 8, device="cpu"),
                            frame_slots=8, overlap=o, extension=e)(*args)
assert all(torch.equal(a, b) for a, b in zip(tp, one))
per = S.drain_timepar_frames(tp, 8)
straddle = [st for lst in per for st, en, _f in lst if st < 4 * t_loc < en]
assert straddle, [[(st, en) for st, en, _f in lst] for lst in per]
print(f"RANK{rank}_OK local={counts} total={int(total[0])} "
      f"frames={[len(lst) for lst in per]}", flush=True)
cluster.shutdown()
'''


def test_two_process_steps(tmp_path):
    port = _free_port()
    outs = _pair(lambda r: [sys.executable, "-c", _WORKER, str(r),
                            f"127.0.0.1:{port}"], tmp_path)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{err[-3000:]}"
        assert f"RANK{rank}_OK" in out and "total=16" in out
    assert outs[0][1].split("frames=")[1] == outs[1][1].split("frames=")[1]


# the port's CLI with its NMEA socket on "nmea.sock" in its directory
_MAIN = ("import functools, sys\n"
         "from gnuais_tpu_torch import cli\n"
         "from gnuais_tpu_torch.io import sinks\n"
         "cli.NmeaSocketServer = functools.partial(sinks.NmeaSocketServer, "
         "'nmea.sock')\n"
         "sys.exit(cli.main(sys.argv[1:]))\n")


def _counters(text):
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
            for m in re.finditer(r"(\w): Received correctly: (\d+) packets, "
                                 r"wrong CRC: (\d+) packets, wrong size: "
                                 r"(\d+) packets", text)}


def test_cluster_cli_two_processes(tmp_path, monkeypatch):
    """``--cluster 127.0.0.1:<port> 2 <rank>`` with ``meshshape 2 4`` on a
    stereo capture, each process 4 logical CPU shards: rank 0's stdout
    (fd 1 shielded from gloo's output) is byte for byte the sequential
    session's, rank 1 writes nothing, and both ranks' counters equal
    it."""
    from test_torch_timepar_cli import _run
    from test_torch_mesh_cli import _stereo
    cap = _stereo(tmp_path, np.random.default_rng(107), 6, 6)
    rc, seq, _t, c_seq = _run(
        "jax", f"soundchannels both\nbackend golden\nsoundinfile {cap}",
        monkeypatch)
    assert rc == 0 and seq.splitlines()
    conf = tmp_path / "fleet.conf"
    conf.write_text(f"soundchannels both\nmeshshape 2 4\n"
                    f"timeparblock 6144\nsoundinfile {cap}\n")
    port = _free_port()
    outs = _pair(lambda r: [sys.executable, "-c", _MAIN, "--device", "cpu",
                            "-c", str(conf), "--cluster",
                            f"127.0.0.1:{port}", "2", str(r)], tmp_path)
    for rank, (rc, _out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{err[-3000:]}"
        assert f"Cluster: process {rank}/2" in err
        assert "Mesh decode: 2x4 devices" in err
    assert outs[0][1] == seq
    assert outs[1][1] == ""
    assert _counters(outs[0][2]) == _counters(outs[1][2]) == c_seq
    assert not torch.distributed.is_initialized()
