"""Signal-chain constants for the AIS receiver.

These pin down the exact numerical contract of the decode chain so the
golden NumPy model, the JAX/Pallas kernels and the host post-processing
all agree bit-for-bit with the reference receiver's behaviour
(reference: gnuais src/receiver.c:39-49 for the taps,
receiver.c:69,84 for the DPLL constants, protodec.c:106-167 for the
CRC contract, protodec.h:41 for buffer caps).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Sample/symbol rates (reference: input.c:73, receiver.c:69)
# ---------------------------------------------------------------------------
SAMPLE_RATE = 48_000          # Hz, S16 PCM input
BAUD_RATE = 9_600             # AIS symbol rate (ITU-R M.1371)
SAMPLES_PER_BIT = SAMPLE_RATE // BAUD_RATE  # = 5

# ---------------------------------------------------------------------------
# Matched FIR band filter: 36 Gaussian-shaped taps for 9600 bd GMSK at
# 48 kHz.  The tap values are part of the receiver's I/O contract (they
# decide which marginal frames pass CRC), so they are reproduced
# verbatim (reference: receiver.c:39-49).  The array is palindromic.
# ---------------------------------------------------------------------------
FIR_TAPS = np.array(
    [
        2.5959e-55, 2.9479e-49, 1.4741e-43, 3.2462e-38, 3.1480e-33,
        1.3443e-28, 2.5280e-24, 2.0934e-20, 7.6339e-17, 1.2259e-13,
        8.6690e-11, 2.6996e-08, 3.7020e-06, 2.2355e-04, 5.9448e-03,
        6.9616e-02, 3.5899e-01, 8.1522e-01, 8.1522e-01, 3.5899e-01,
        6.9616e-02, 5.9448e-03, 2.2355e-04, 3.7020e-06, 2.6996e-08,
        8.6690e-11, 1.2259e-13, 7.6339e-17, 2.0934e-20, 2.5280e-24,
        1.3443e-28, 3.1480e-33, 3.2462e-38, 1.4741e-43, 2.9479e-49,
        2.5959e-55,
    ],
    dtype=np.float32,
)
FIR_LEN = 36

# The reference FIR has a one-sample delay: the sample written at the
# buffer head is NOT part of the MAC for that output sample
# (filter.c:115-122: buffer[pointer]=x then MAC over
# buffer[pointer-36 .. pointer-1]).  So out[n] = sum_i taps[i]*x[n-36+i].
FIR_DELAY = 1

# ---------------------------------------------------------------------------
# DPLL clock recovery (16-bit phase accumulator, receiver.c:69,84,109-134)
# ---------------------------------------------------------------------------
PLL_WRAP = 0x10000            # 16-bit phase space
PLL_INC = PLL_WRAP // 5       # = 13107, one bit per 5 samples
PLL_NUDGE_DIV = 16            # "INC" in the reference
PLL_NUDGE = PLL_INC // PLL_NUDGE_DIV  # = 819 (integer division)
PLL_CENTER = PLL_WRAP // 2    # 0x8000 threshold for nudge direction

# ---------------------------------------------------------------------------
# HDLC deframer (protodec.c:988-1122, protodec.h:30-41)
# ---------------------------------------------------------------------------
# State machine states (values match the reference for readability of
# traces; any distinct values would do).
ST_SKURR = 1      # noise hunt
ST_PREAMBLE = 2   # preamble alternation tracking
ST_STARTSIGN = 3  # start-flag tail
ST_DATA = 4       # data accumulation w/ destuffing
ST_STOPSIGN = 5   # end-flag seen, frame finalization

DEMOD_BUFFER_LEN = 450        # bit buffer cap; reset at bufferpos >= 449
MAX_FRAME_DATA_BITS = 449
# On stop flag: payload length = bufferpos - 6 (flag bits counted as
# data before detection) - 16 (FCS) (protodec.c:1096)
FRAME_TAIL_BITS = 6 + 16

# CRC-16 X.25 (reflected poly 0x8408, init 0xffff, final complement);
# accept iff complemented CRC over (byte-truncated payload + 16 FCS
# bits) equals the magic residue (protodec.c:106-167)
CRC_POLY_REFLECTED = 0x8408
CRC_INIT = 0xFFFF
CRC_MAGIC_RESIDUE = 0x0F47

# ---------------------------------------------------------------------------
# AIS message surface (protodec.c:896-986, cfg.h:48)
# ---------------------------------------------------------------------------
MAX_AIS_PACKET_TYPE = 24
NMEA_SENLEN = 61              # six-bit payload chars per !AIVDM sentence

# Sound-channel modes (cfg.h:64-67)
SOUND_CHANNELS_MONO = 1
SOUND_CHANNELS_BOTH = 2
SOUND_CHANNELS_LEFT = 3
SOUND_CHANNELS_RIGHT = 4

# Default processing block: 1024 frames like the reference main loop
# (ais.c:179-182); the TPU pipeline uses much larger blocks internally.
DEFAULT_BLOCK_FRAMES = 1024

# Precomputed byte-wise CRC table for the reflected X.25 polynomial.
# The bit-serial definition (protodec_sdlc_crc) processes each data byte
# LSB-first; the table below gives the identical transformation one byte
# at a time: crc' = (crc >> 8) ^ TABLE[(crc ^ byte) & 0xff].
def _make_crc_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint16)
    for b in range(256):
        c = b
        for _ in range(8):
            if c & 1:
                c = (c >> 1) ^ CRC_POLY_REFLECTED
            else:
                c >>= 1
        tab[b] = c
    return tab


CRC_TABLE = _make_crc_table()


def crc16_x25(data: bytes | np.ndarray, init: int = CRC_INIT) -> int:
    """CRC-16/X.25 over bytes, LSB-first, NOT complemented.

    ``protodec_sdlc_crc`` returns the complement; the frame-accept
    condition ``~crc == 0x0f47`` is therefore ``crc == 0xf0b8`` in this
    un-complemented convention.
    """
    crc = init
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    for b in arr:
        crc = (crc >> 8) ^ int(CRC_TABLE[(crc ^ int(b)) & 0xFF])
    return crc


# un-complemented good residue: ~0x0f47 & 0xffff
CRC_GOOD = (~CRC_MAGIC_RESIDUE) & 0xFFFF  # 0xf0b8
