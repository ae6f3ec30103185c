"""The port's SupervisedDecoder (``runtime/supervisor``) on the CPU,
held against an uninterrupted run of the JAX package's BatchPipeline on
the same capture: a failure injected at a block, a process restart from
the checkpoint, and a fault that never clears (the counterparts of
``tests/test_supervisor.py``).  Payloads and counters exactly equal."""

import numpy as np
import pytest

from gnuais_tpu.golden import encoder as E
from gnuais_tpu.runtime.pipeline import BatchPipeline as JaxPipeline
from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
from gnuais_tpu_torch.runtime.supervisor import (DecodeFailure,
                                                 SupervisedDecoder)

BL = 1024


def _capture(n_payloads, seed):
    rng = np.random.default_rng(seed)
    audio = E.synthesize_capture(
        [E.random_payload(rng) for _ in range(n_payloads)], gap_bits=40)
    n_blocks = -(-len(audio) // BL)
    return np.pad(audio, (0, n_blocks * BL - len(audio))), n_blocks


def _payloads(frames):
    return [f.payload_bits[:f.bufferlen].tobytes() for f in frames]


def _jax_run(audio, n_blocks):
    """The uninterrupted JAX run's payloads and counters."""
    ref = JaxPipeline(1, block_len=BL, frame_slots=16)
    want = []
    for b in range(n_blocks):
        want += ref.process(audio[None, b * BL:(b + 1) * BL])[0]
    c = ref.counters[0]
    return _payloads(want), (c.receivedframes, c.lostframes, c.lostframes2)


@pytest.fixture(scope="module")
def capture8():
    audio, n_blocks = _capture(8, 21)
    return audio, n_blocks, _jax_run(audio, n_blocks)


def _pipe():
    return BatchPipeline(1, block_len=BL, frame_slots=16, device="cpu")


class FlakyPipeline(BatchPipeline):
    """Raises once at a chosen absolute block index."""

    fail_at = None        # class attrs: shared across rebuilds,
    calls = 0             # like a real transient device fault

    def process(self, samples):
        FlakyPipeline.calls += 1
        if FlakyPipeline.calls - 1 == FlakyPipeline.fail_at:
            raise RuntimeError("injected device failure")
        return super().process(samples)


@pytest.mark.parametrize("fail_block", [0, 3, 5])
def test_recovery_is_exact(tmp_path, capture8, fail_block):
    audio, n_blocks, (want, want_counters) = capture8
    FlakyPipeline.fail_at = fail_block
    FlakyPipeline.calls = 0
    events = []
    sup = SupervisedDecoder(
        lambda: FlakyPipeline(1, block_len=BL, frame_slots=16, device="cpu"),
        tmp_path / "ckpt.npz", checkpoint_every=2, retry_backoff=0.0,
        on_event=lambda k, d: events.append(k))
    got = []
    for b in range(n_blocks):
        got += sup.process(audio[None, b * BL:(b + 1) * BL])[0]
    assert _payloads(got) == want and len(want) == 8
    c = sup.counters[0]
    assert (c.receivedframes, c.lostframes, c.lostframes2) == want_counters
    assert "failure" in events and "recovered" in events
    # the rebuilt pipeline stays on the device the factory names
    assert sup.pipe.device.type == "cpu" and sup.pipe.carry.history.device.type == "cpu"


def test_crash_restart_resumes_exactly(tmp_path):
    audio, n_blocks = _capture(8, 33)
    want, want_counters = _jax_run(audio, n_blocks)
    path = tmp_path / "ckpt.npz"
    sup1 = SupervisedDecoder(_pipe, path, checkpoint_every=2)
    got = []
    half = (n_blocks // 2) // 2 * 2        # stop ON a checkpoint boundary
    for b in range(half):
        got += sup1.process(audio[None, b * BL:(b + 1) * BL])[0]
    del sup1                                # simulated process death

    sup2 = SupervisedDecoder(_pipe, path, checkpoint_every=2)
    assert sup2.resume_offset() == half * BL
    for b in range(half, n_blocks):
        got += sup2.process(audio[None, b * BL:(b + 1) * BL])[0]
    assert _payloads(got) == want and len(want) == 8
    c = sup2.counters[0]
    assert (c.receivedframes, c.lostframes, c.lostframes2) == want_counters


def test_unrecoverable_raises(tmp_path):
    audio, _ = _capture(2, 1)

    class AlwaysFails(BatchPipeline):
        def process(self, samples):
            raise RuntimeError("hard fault")

    events = []
    sup = SupervisedDecoder(
        lambda: AlwaysFails(1, block_len=BL, frame_slots=16, device="cpu"),
        tmp_path / "ckpt.npz", max_retries=2, retry_backoff=0.0,
        on_event=lambda k, d: events.append(k))
    with pytest.raises(DecodeFailure):
        sup.process(audio[None, :BL])
    assert events.count("failure") == 3
