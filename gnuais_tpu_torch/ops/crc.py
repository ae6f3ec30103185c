"""Batched CRC-16/X.25 frame check on the device, linear (GF(2)) form
(counterpart of ``gnuais_tpu/ops/crc.py``, ``crc_check_frames_linear``),
and the JAX module's byte-table helpers (``frames_to_line_bits``,
``crc_check_frames``, ``extract_payload_bits``), torch ops on the
caller's device.  Register words are int32 bit patterns, as everywhere
in the port (the JAX package's uint32).

The byte-table CRC is an affine map over GF(2): the final CRC is a
length-dependent constant XOR the XOR over set frame bits of a 16-bit
weight that depends only on the bit's distance from the frame end (the
register is end-aligned) and on payload_len % 8.  XOR is per-bit parity,
so the whole reduction is one float32 product of the frame bits
[F, 480] with 0/1 weight planes [480, 8*16], then a parity and a select
of the payload_len % 8 hypothesis.  Tables are built in numpy from the
shared constants, with the same derivation as the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

from .demod import REG_BITS


def _crc_bytes_ref(data: bytes, init: int) -> int:
    crc = init
    for b in data:
        crc = (crc >> 8) ^ int(C.CRC_TABLE[(crc ^ b) & 0xFF])
    return crc & 0xFFFF


def _build_tables():
    # bitw[ba*8 + i]: final-CRC effect (init 0) of data bit i set in a
    # byte followed by ba zero bytes
    bitw = np.zeros(60 * 8, dtype=np.int64)
    for ba in range(60):
        for i in range(8):
            bitw[ba * 8 + i] = _crc_bytes_ref(bytes([1 << i]) + b"\x00" * ba, 0)
    # init[L]: CRC of L zero bytes with init 0xffff
    init = np.array([_crc_bytes_ref(b"\x00" * n, 0xFFFF) for n in range(64)],
                    dtype=np.int64)
    # w8[r, p]: weight of register position p (0 = newest bit) for
    # payload_len % 8 == r.  p in [6, 22) are the 16 FCS bits; p >= 22
    # are payload bits, included iff p > 21 + r (whole-byte truncation
    # drops the newest r payload bits)
    w8 = np.zeros((8, REG_BITS), dtype=np.int64)
    for r in range(8):
        for p in range(6, 22):
            f = 21 - p
            w8[r, p] = bitw[(1 - f // 8) * 8 + (f % 8)]
        for p in range(22 + r, REG_BITS):
            i = (r + 5 - p) % 8
            idx = p - r - 13 + 2 * i
            if 0 <= idx < len(bitw):
                w8[r, p] = bitw[idx]
    # planes[p, r*16 + j] = bit j of w8[r, p], as 0/1 float32
    planes = ((w8.T[:, :, None] >> np.arange(16)) & 1).reshape(REG_BITS, 128)
    return planes.astype(np.float32), init.astype(np.int32)


_PLANES, _INIT_CRC = _build_tables()
_CRC_TARGET = 0xF0B8    # residue 0x0f47 complemented (protodec.c:166)
_device_tables: dict = {}


def _tables(dev: torch.device):
    """The weight planes and init CRCs on ``dev``, copied there once."""
    if dev not in _device_tables:
        _device_tables[dev] = (torch.as_tensor(_PLANES, device=dev),
                               torch.as_tensor(_INIT_CRC, device=dev))
    return _device_tables[dev]


def frames_to_line_bits(words: torch.Tensor,
                        total_bits: torch.Tensor) -> torch.Tensor:
    """Register snapshots unpacked to line-order bit rows.

    words: [F, REG_WORDS] int32 (the newest appended bit is the LSB of
    the last word); total_bits: [F] int32, payload + 22.  Returns int32
    [F, REG_BITS] whose column 0 is each frame's first appended bit
    (frames shorter than REG_BITS left-aligned, zero-padded)."""
    dev = words.device
    j = torch.arange(REG_BITS, device=dev)
    # bit j of the register (0 = the oldest kept) is bit 31 - j % 32 of
    # word j // 32
    reg_bits = (words[:, j // 32] >> (31 - j % 32).to(torch.int32)) & 1
    total = total_bits.to(torch.int64)[:, None]
    idx = (REG_BITS - total + j[None, :]).clamp(0, REG_BITS - 1)
    out = reg_bits.gather(1, idx)
    return torch.where(j[None, :] < total, out, 0).to(torch.int32)


def _line_bytes(words: torch.Tensor, payload_len: torch.Tensor):
    """The frames' line-order bits as [F, REG_BITS / 8, 8] groups."""
    bits = frames_to_line_bits(words, payload_len + C.FRAME_TAIL_BITS)
    return bits.reshape(-1, REG_BITS // 8, 8)


def crc_check_frames(words: torch.Tensor,
                     payload_len: torch.Tensor) -> torch.Tensor:
    """Accept mask for frame snapshots by the byte table, as the reference
    computes it (``crc_check_frames_linear`` is the same function as one
    product).  words: [F, REG_WORDS] int32; payload_len: [F] int32.
    Returns bool [F]."""
    dev = words.device
    b = _line_bytes(words, payload_len)
    # LSB-first bytes: bit i of a byte has weight 2^i
    data = (b * (1 << torch.arange(8, dtype=torch.int32, device=dev))).sum(
        dim=2, dtype=torch.int32)                                 # [F, 60]
    buflen = payload_len // 8 + 2
    tab = torch.as_tensor(C.CRC_TABLE.astype(np.int32), device=dev)
    crc = torch.full((words.shape[0],), C.CRC_INIT, dtype=torch.int32,
                     device=dev)
    for k in range(data.shape[1]):
        nxt = (crc >> 8) ^ tab[((crc ^ data[:, k]) & 0xFF).long()]
        crc = torch.where(k < buflen, nxt, crc)
    return (((~crc) & 0xFFFF) == C.CRC_MAGIC_RESIDUE) & (payload_len > 0)


def extract_payload_bits(words: torch.Tensor,
                         payload_len: torch.Tensor) -> torch.Tensor:
    """The frames' payloads in AIS order, MSB first within each byte,
    whole bytes only (the reference's rbuffer re-expansion): int32
    [F, REG_BITS], zero past the payload's whole bytes."""
    b = _line_bytes(words, payload_len)
    msb = b.flip(2).reshape(-1, REG_BITS)
    j = torch.arange(REG_BITS, device=words.device)
    return torch.where(j[None, :] < (payload_len // 8 * 8)[:, None], msb, 0)


def crc_check_frames_linear(words: torch.Tensor,
                            payload_len: torch.Tensor) -> torch.Tensor:
    """Accept mask for frame snapshots, bit-identical to the reference's
    byte-table check.  words: [F, REG_WORDS] int32 (uint32 bits);
    payload_len: [F] int32.  Returns bool [F].

    The product is exact whatever ``torch.backends.cuda.matmul.allow_tf32``
    says: both operands are 0/1, which TF32 holds exactly, products
    accumulate in float32, and the sums (at most 480) are integers that
    float32 holds exactly.  So this function leaves the flag alone."""
    dev = words.device
    planes, init_crc = _tables(dev)
    f = words.shape[0]
    # bits by position from the end: word 14 bit 0 is p = 0
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    bits = ((words.flip(1)[:, :, None] >> shifts) & 1).reshape(f, REG_BITS)
    r = payload_len % 8
    nbytes = payload_len // 8 + 2
    p = torch.arange(REG_BITS, dtype=torch.int32, device=dev)
    inframe = p[None, :] < (payload_len + C.FRAME_TAIL_BITS)[:, None]
    bitsf = torch.where(inframe, bits, 0).to(torch.float32)
    sums = bitsf @ planes                                        # [F, 128]
    parity = (sums.to(torch.int32) & 1).reshape(f, 8, 16)
    weights = 1 << torch.arange(16, dtype=torch.int32, device=dev)
    crc_all = (parity * weights).sum(dim=2)                      # [F, 8]
    crc_data = crc_all.gather(1, r.long()[:, None])[:, 0]
    init = init_crc[nbytes.clamp(0, 63).long()]
    return ((crc_data ^ init) == _CRC_TARGET) & (payload_len > 0)
