"""Frame -> output dispatcher (the equivalent of protodec_getdata,
protodec.c:896-986).

Takes CRC-verified payload frames (from the golden model or the TPU
pipeline) and produces, per message:
  - the stdout display line  ``ch A type 1 mmsi 000000001: ... (!AIVDM...)``
  - the full !AIVDM sentence list for serial/socket/DB sinks
  - structured sink events (cache/DB/range)

Channel state (rolling NMEA sequence number) lives here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from gnuais_tpu_torch.ais import nmea as nmea_mod
from gnuais_tpu_torch.ais import parser as parser_mod
from gnuais_tpu_torch.ais.bits import henten, pad_payload
from gnuais_tpu_torch.constants import MAX_AIS_PACKET_TYPE
from gnuais_tpu_torch.runtime import trace


@dataclass
class DecodedMessage:
    type: int
    mmsi: int
    chanid: str               # receiving channel ("A"/"B")
    stdout_line: str          # full line as printed by the reference
    nmea_sentences: List[str]  # all sentences incl. leading '!'
    events: List[parser_mod.Event]
    payload_bits: np.ndarray  # padded payload (MSB-first)
    bufferlen: int            # padded bit length


class ChannelDispatcher:
    """Per-channel message formatter with rolling sequence number and
    skip_type configuration."""

    def __init__(self, chanid: str = "A",
                 skip_type: Optional[Sequence[int]] = None) -> None:
        self.chanid = chanid
        self.seqnr = 0
        self.skip = set(skip_type or ())

    def dispatch(self, payload_bits: np.ndarray, bufferlen: int) -> Optional[DecodedMessage]:
        """payload_bits: MSB-first bit array of length >= bufferlen
        (whole bytes); bufferlen: the frame's payload bit count.

        Returns None for out-of-range types (dropped with no output and
        no seqnr roll, protodec.c:898-900).  For skipped types the NMEA
        is still generated and seqnr still rolls; only the stdout line
        is suppressed (protodec.c:920-932).

        Traced (``runtime.trace``, summed, never annotated): the call
        (``ais.dispatch``), the NMEA encoder (``ais.nmea``), the parser
        with the stdout line (``ais.parse``); ``ais.messages`` counts
        the messages.
        """
        with trace.span("ais.dispatch"):
            rb = pad_payload(payload_bits[:bufferlen])
            msg_type = henten(0, 6, rb)
            if msg_type < 1 or msg_type > MAX_AIS_PACKET_TYPE:
                return None
            mmsi = henten(8, 30, rb)

            fillbits = 0
            if bufferlen % 6 > 0:
                fillbits = 6 - (bufferlen % 6)
                bufferlen = bufferlen + fillbits  # rb already zero-padded

            with trace.span("ais.nmea"):
                sentences = nmea_mod.generate_nmea(rb, bufferlen, fillbits,
                                                   self.seqnr)
            self.seqnr += 1
            if self.seqnr > 9:
                self.seqnr = 0

            stdout_line = ""
            parsed = None
            if msg_type not in self.skip:
                with trace.span("ais.parse"):
                    parsed = parser_mod.parse(rb, bufferlen)
                    # parsed cannot be None here (type already
                    # range-checked)
                    stdout_line = (
                        f"ch {self.chanid} type {msg_type} mmsi "
                        f"{mmsi:09d}:{parsed.text} ({sentences[-1]})"
                    )
            trace.count("ais.messages")

            return DecodedMessage(
                type=msg_type,
                mmsi=mmsi,
                chanid=self.chanid,
                stdout_line=stdout_line,
                nmea_sentences=sentences,
                events=parsed.events if parsed else [],
                payload_bits=rb,
                bufferlen=bufferlen,
            )
