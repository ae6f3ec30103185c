"""Input/output: audio capture readers (raw S16 / WAV / IQ), block
streaming, and output sinks (stdout, NMEA socket broadcast, serial,
database, JSON-AIS uplink)."""

from gnuais_tpu_torch.io import audio  # noqa: F401
