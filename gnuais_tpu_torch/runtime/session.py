"""Decode session: the equivalent of the reference main loop
(ais.c:214-263) — feeds capture blocks through per-channel receivers
and dispatches decoded frames to outputs in the reference's order
(channel A fully processed before channel B within each block).

Backend-agnostic: any object with ``run_block(int16[n]) -> [Frame]``
works as a channel receiver (golden model or the JAX pipeline adapter).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from gnuais_tpu_torch.ais.dispatcher import ChannelDispatcher, DecodedMessage
from gnuais_tpu_torch.constants import (
    SOUND_CHANNELS_BOTH,
    SOUND_CHANNELS_LEFT,
    SOUND_CHANNELS_MONO,
    SOUND_CHANNELS_RIGHT,
)
from gnuais_tpu_torch.io.audio import deinterleave, iter_blocks


@dataclass
class SessionResult:
    messages: List[DecodedMessage] = field(default_factory=list)
    stdout_lines: List[str] = field(default_factory=list)
    nmea_sentences: List[str] = field(default_factory=list)
    counters: dict = field(default_factory=dict)


class DecodeSession:
    """Orchestrates 1-2 channel receivers over an interleaved capture."""

    def __init__(self,
                 make_receiver: Callable[[str], object],
                 sound_channels: int = SOUND_CHANNELS_MONO,
                 skip_type: Optional[Sequence[int]] = None,
                 message_callback: Optional[Callable[[DecodedMessage], None]] = None):
        self.sound_channels = sound_channels
        self.nch = 1 if sound_channels == SOUND_CHANNELS_MONO else 2
        # Both receivers are created whenever not mono, even if only one
        # runs (ais.c:139-149).
        self.rx_a = make_receiver("A")
        self.rx_b = make_receiver("B") if self.nch == 2 else None
        self.disp_a = ChannelDispatcher("A", skip_type)
        self.disp_b = ChannelDispatcher("B", skip_type) if self.nch == 2 else None
        self.message_callback = message_callback

    def _run_channel(self, rx, disp, block: np.ndarray, ch_ofs: int,
                     result: SessionResult) -> None:
        samples = deinterleave(block, self.nch, ch_ofs)
        for fr in rx.run_block(samples):
            msg = disp.dispatch(fr.payload_bits, fr.bufferlen)
            if msg is None:
                continue
            result.messages.append(msg)
            if msg.stdout_line:
                result.stdout_lines.append(msg.stdout_line)
            result.nmea_sentences.extend(msg.nmea_sentences)
            if self.message_callback:
                self.message_callback(msg)

    def process_block(self, block: np.ndarray, result: SessionResult) -> None:
        sc = self.sound_channels
        if sc == SOUND_CHANNELS_MONO:
            self._run_channel(self.rx_a, self.disp_a, block, 0, result)
            return
        if sc in (SOUND_CHANNELS_BOTH, SOUND_CHANNELS_RIGHT):
            self._run_channel(self.rx_a, self.disp_a, block, 0, result)
        if sc in (SOUND_CHANNELS_BOTH, SOUND_CHANNELS_LEFT):
            self._run_channel(self.rx_b, self.disp_b, block, 1, result)

    def run(self, interleaved: np.ndarray,
            block_frames: Optional[int] = None) -> SessionResult:
        result = SessionResult()
        for block in iter_blocks(interleaved, self.nch, block_frames):
            self.process_block(block, result)
        for name, rx in (("A", self.rx_a), ("B", self.rx_b)):
            if rx is not None and hasattr(rx, "counters"):
                result.counters[name] = rx.counters
        return result
