"""The work of the program's IQ front end (``ops.discriminator``:
the discriminator, the decimator, the rounding to int16) and its bound
on the card's peaks (``card.py``).

Bytes: each IQ sample's I and Q, float32, read once (8 bytes) and each
audio sample, int16, written once (2 bytes).  Operations: an IQ sample's
discriminator takes 4 multiplies and 2 adds for z[n] conj(z[n-1]), an
``atan2`` (counted as one: no peak is published for it) and the scale;
an audio sample's decimator takes 64 multiplies and 63 adds, then the
rounding and the clip.  The bound is the longer of the two times.
"""

from __future__ import annotations

from .card import bound_ms

IQ_BYTES = 8
AUDIO_BYTES = 2
IQ_OPS = 4 + 2 + 1 + 1
AUDIO_OPS = 64 + 63 + 2


def frontend_bound_ms(streams: int, iq_samples: int, decim: int) -> float:
    """The least time of the front end over ``iq_samples`` IQ samples of
    each of ``streams`` streams at ``decim`` IQ samples an audio
    sample."""
    audio = iq_samples // decim
    nbytes = streams * (IQ_BYTES * iq_samples + AUDIO_BYTES * audio)
    ops = streams * (IQ_OPS * iq_samples + AUDIO_OPS * audio)
    return bound_ms(nbytes, ops)[0]
