"""Host-side AIS protocol layer: payload field extraction (message types
1-24), NMEA 0183 !AIVDM encoding, and JSON-AIS export structures.

This is the cold path of the receiver (a few hundred messages/s at
most); it runs on the host, fed by device-decoded frames.  Text output
is byte-compatible with the reference decoder's stdout/NMEA surface
(reference: protodec.c:190-986 field extraction, :780-894 NMEA).
"""

from gnuais_tpu_torch.ais import bits, nmea, parser  # noqa: F401
