"""Golden CPU model of the full decode chain.

A pure-NumPy, bit-exact re-derivation of the reference receiver's
behaviour (FIR -> DPLL -> NRZI -> HDLC -> CRC -> AIS), used as the
correctness oracle for the TPU kernels, plus a synthetic AIS capture
generator for building test vectors without recorded audio.
"""

from gnuais_tpu_torch.golden import encoder, model  # noqa: F401
