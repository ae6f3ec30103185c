"""NMEA 0183 !AIVDM sentence generation.

Byte-compatible with the reference encoder (protodec_generate_nmea,
protodec.c:780-894), including its quirks, which are part of the
observable output contract:

 - max 61 six-bit chars of payload per sentence;
 - single-part sentences always carry channel "A" and an empty sequence
   field (``!AIVDM,1,1,,A,...``) regardless of the actual channel;
 - multi-part sentences carry the rolling sequence id (0..9, shared per
   channel) and an EMPTY channel field (``!AIVDM,2,1,<seq>,,...``);
 - the fill-bits digit is only written on the last sentence of a
   multi-part message; single-part sentences always show ``0``;
 - checksum is the XOR of everything between ``!`` and ``*``, printed
   with C ``%X`` (uppercase, no zero padding) placed right-aligned in a
   two-char field pre-filled with ``0``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .bits import henten
from .constants import NMEA_SENLEN


def sixbit_to_nmea_char(letter: int) -> str:
    """IEC 6-bit value -> AIVDM payload character (protodec.c:809-813)."""
    return chr(letter + 48) if letter < 40 else chr(letter + 56)


def generate_nmea(rbuffer: np.ndarray, bufferlen: int, fillbits: int,
                  seqnr: int) -> List[str]:
    """Build the !AIVDM sentence(s) for one message.

    ``rbuffer``: MSB-first payload bits zero-padded to a 6-bit multiple;
    ``bufferlen``: padded bit length; ``seqnr``: the channel's rolling
    sequence number to stamp on multi-part messages.

    Returns full sentences including the leading ``!`` (the serial sink
    appends CRLF; the socket sink sends them bare — reference
    protodec.c:883-888).
    """
    if bufferlen <= NMEA_SENLEN * 6:
        sentences = 1
    else:
        sentences = bufferlen // (NMEA_SENLEN * 6)
        if bufferlen % (NMEA_SENLEN * 6) != 0:
            sentences += 1

    out: List[str] = []
    pos = 0
    for sentencenum in range(1, sentences + 1):
        payload_chars = []
        while len(payload_chars) < NMEA_SENLEN and bufferlen > pos:
            payload_chars.append(sixbit_to_nmea_char(henten(pos, 6, rbuffer)))
            pos += 6
        payload = "".join(payload_chars)

        if sentences > 1:
            seq_field = chr(seqnr + 48)
            chan_field = ""
            fill_digit = chr(48 + fillbits) if sentencenum == sentences else "0"
        else:
            seq_field = ""
            chan_field = "A"
            fill_digit = "0"

        body = (
            f"AIVDM,{sentences},{sentencenum},{seq_field},{chan_field},"
            f"{payload},{fill_digit}"
        )
        chk = 0
        for ch in body:
            chk ^= ord(ch)
        hexchk = f"{chk:X}"
        # two-char field pre-filled with '0'; single hex digit goes in
        # the low position (protodec.c:870-880)
        if len(hexchk) == 1:
            hexchk = "0" + hexchk
        out.append(f"!{body}*{hexchk}")
    return out


class NmeaChannelState:
    """Rolling per-channel sequence number (0..9), incremented once per
    message after generation (protodec.c:922-926)."""

    def __init__(self) -> None:
        self.seqnr = 0

    def next_seqnr(self) -> None:
        self.seqnr += 1
        if self.seqnr > 9:
            self.seqnr = 0
