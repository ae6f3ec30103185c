// Native host-side runtime for gnuais-tpu.
//
// The device pipeline emits rare, compact artifacts (frame register
// snapshots); at hundreds of streams the Python drain becomes the
// bottleneck, so the hot host paths live here:
//
//  * drain_frames:   register snapshots -> payload bits + CRC verdicts
//                    (the host half of the decode contract; semantics
//                    of protodec_calculate_crc re-derived from spec:
//                    LSB-first byte packing, whole-byte payload
//                    truncation, X.25 residue check)
//  * hdlc_decode:    a full bit-level HDLC deframer, state-machine
//                    compatible with the device scan — used by the
//                    time-parallel overlap resolver and as a fast
//                    host-side reference
//  * crc16_x25:      the frame checksum
//
// Exposed as a plain C ABI for ctypes; no Python.h dependency.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-16/X.25 (reflected 0x8408, init 0xffff); accept residue after
// complement is 0x0f47.
// ---------------------------------------------------------------------------

static uint16_t crc_table[256];
static bool crc_table_ready = false;

static void crc_init_table() {
    if (crc_table_ready) return;
    for (int b = 0; b < 256; b++) {
        uint16_t c = (uint16_t)b;
        for (int i = 0; i < 8; i++)
            c = (c & 1) ? (uint16_t)((c >> 1) ^ 0x8408) : (uint16_t)(c >> 1);
        crc_table[b] = c;
    }
    crc_table_ready = true;
}

uint16_t crc16_x25(const uint8_t* data, int len) {
    crc_init_table();
    uint16_t crc = 0xffff;
    for (int i = 0; i < len; i++)
        crc = (uint16_t)((crc >> 8) ^ crc_table[(crc ^ data[i]) & 0xff]);
    return crc;
}

// ---------------------------------------------------------------------------
// Frame drain: [S, F, W] uint32 register snapshots -> payload bits.
//
// Register layout (matches ops/demod.py): 15 x 32-bit words, the most
// recently appended bit is the LSB of word 14; a frame of
// payload_len+22 bits occupies the trailing bit positions.
//
// Outputs, per frame k (k < counts[s], all frames of stream s first):
//   meta[4*k+0] = stream index
//   meta[4*k+1] = payload bit length
//   meta[4*k+2] = crc_ok (0/1)
//   meta[4*k+3] = byte offset into payload_out
//   payload_out: payload bits MSB-first-per-byte expansion, one bit per
//   byte (rbuffer order), (len/8)*8 entries.
// Returns the number of frames written.
// ---------------------------------------------------------------------------

int drain_frames(const uint32_t* words, const int32_t* lens,
                 const int32_t* counts, int S, int F, int W,
                 uint8_t* payload_out, int payload_cap,
                 int32_t* meta, int meta_cap_frames) {
    crc_init_table();
    const int REG_BITS = W * 32;
    int nframes = 0;
    int payload_off = 0;
    uint8_t linebits[512];
    uint8_t packed[64];

    for (int s = 0; s < S; s++) {
        int cnt = counts[s];
        if (cnt > F) cnt = F;
        for (int k = 0; k < cnt; k++) {
            if (nframes >= meta_cap_frames) return nframes;
            const uint32_t* reg = words + ((size_t)s * F + k) * W;
            int plen = lens[(size_t)s * F + k];
            int total = plen + 22;              // + 16 FCS + 6 flag bits
            if (total > REG_BITS) total = REG_BITS;

            // unpack the trailing `total` bits, oldest first
            for (int j = 0; j < total; j++) {
                int pos = REG_BITS - total + j; // register bit index
                int w = pos / 32;
                int sh = 31 - (pos % 32);
                linebits[j] = (uint8_t)((reg[w] >> sh) & 1u);
            }

            // CRC over length_bytes+2 bytes packed LSB-first
            int length_bytes = plen / 8;
            int buflen = length_bytes + 2;
            int ok = 0;
            if (plen > 0 && buflen * 8 <= total) {
                for (int j = 0; j < buflen; j++) {
                    uint8_t v = 0;
                    for (int i = 0; i < 8; i++)
                        v |= (uint8_t)(linebits[j * 8 + i] << i);
                    packed[j] = v;
                }
                uint16_t crc = crc16_x25(packed, buflen);
                ok = ((uint16_t)~crc & 0xffff) == 0x0f47;
            }

            int out_bits = length_bytes * 8;
            if (payload_off + out_bits > payload_cap) return nframes;
            // rbuffer re-expansion: per-byte bit reversal of line order
            for (int j = 0; j < length_bytes; j++)
                for (int i = 0; i < 8; i++)
                    payload_out[payload_off + j * 8 + i] =
                        linebits[j * 8 + (7 - i)];

            meta[4 * nframes + 0] = s;
            meta[4 * nframes + 1] = plen;
            meta[4 * nframes + 2] = ok;
            meta[4 * nframes + 3] = payload_off;
            payload_off += out_bits;
            nframes++;
        }
    }
    return nframes;
}

// ---------------------------------------------------------------------------
// HDLC bit-level deframer (host).  Semantics identical to the device
// scan (ops/demod.py) / golden model.
// ---------------------------------------------------------------------------

struct HdlcState {
    int32_t state;           // 1..5
    int32_t last;
    int32_t antallpreamble;
    int32_t nstartsign;
    int32_t antallenner;
    int32_t bitstuff;
    int32_t bufferpos;
    int32_t receivedframes;
    int32_t lostframes;
    int32_t lostframes2;
    uint8_t buffer[450];
};

enum { ST_SKURR = 1, ST_PREAMBLE = 2, ST_STARTSIGN = 3,
       ST_DATA = 4, ST_STOPSIGN = 5 };

void hdlc_init(HdlcState* d) {
    memset(d, 0, sizeof(*d));
    d->state = ST_SKURR;
}

static void hdlc_reset(HdlcState* d) {
    d->state = ST_SKURR;
    d->antallpreamble = 0;
    d->nstartsign = 0;
    d->antallenner = 0;
    d->last = 0;
    d->bitstuff = 0;
    d->bufferpos = 0;
}

// Decodes `n` bits; emits CRC-passing frames into payload_out/meta in
// the same format as drain_frames (stream field = 0).  Returns frames
// written.
int hdlc_decode(HdlcState* d, const uint8_t* bits, int n,
                uint8_t* payload_out, int payload_cap,
                int32_t* meta, int meta_cap_frames) {
    crc_init_table();
    int nframes = 0;
    int payload_off = 0;
    uint8_t packed[64];

    for (int i = 0; i < n; i++) {
        int b = bits[i] & 1;
        switch (d->state) {
        case ST_DATA:
            if (d->bitstuff) {
                if (b == 1) {
                    d->state = ST_STOPSIGN;
                    d->bitstuff = 0;
                } else {
                    d->bitstuff = 0;
                }
            } else {
                if (b == 1 && d->last == 1) {
                    if (++d->antallenner == 4) {
                        d->bitstuff = 1;
                        d->antallenner = 0;
                    }
                } else {
                    d->antallenner = 0;
                }
                d->buffer[d->bufferpos++] = (uint8_t)b;
                if (d->bufferpos >= 449)
                    hdlc_reset(d);
            }
            break;
        case ST_SKURR:
            if (b != d->last) d->antallpreamble++; else d->antallpreamble = 0;
            d->last = b;
            if (d->antallpreamble > 14 && b == 0) {
                d->state = ST_PREAMBLE;
                d->antallpreamble = 0;
            }
            break;
        case ST_PREAMBLE:
            if (b != d->last && d->nstartsign == 0) {
                d->antallpreamble++;
            } else if (b == 1) {
                if (d->nstartsign == 0) {
                    d->nstartsign = 3;
                    d->last = b;
                } else if (d->nstartsign == 5) {
                    d->nstartsign++;
                    d->antallpreamble = 0;
                    d->state = ST_STARTSIGN;
                } else {
                    d->nstartsign++;
                }
            } else {
                if (d->nstartsign == 0) d->nstartsign = 1;
                else hdlc_reset(d);
            }
            break;
        case ST_STARTSIGN:
            if (d->nstartsign >= 7) {
                if (b == 0) {
                    d->state = ST_DATA;
                    d->nstartsign = 0;
                    d->antallenner = 0;
                    memset(d->buffer, 0, sizeof(d->buffer));
                    d->bufferpos = 0;
                } else {
                    hdlc_reset(d);
                }
            } else if (b == 0) {
                hdlc_reset(d);
            }
            d->nstartsign++;
            break;
        case ST_STOPSIGN: {
            int plen = d->bufferpos - 22;
            if (b == 0 && plen > 0) {
                int length_bytes = plen / 8;
                int buflen = length_bytes + 2;
                int ok = 0;
                for (int j = 0; j < buflen; j++) {
                    uint8_t v = 0;
                    for (int bi = 0; bi < 8; bi++)
                        v |= (uint8_t)(d->buffer[j * 8 + bi] << bi);
                    packed[j] = v;
                }
                uint16_t crc = crc16_x25(packed, buflen);
                ok = ((uint16_t)~crc & 0xffff) == 0x0f47;
                if (ok) {
                    d->receivedframes++;
                    int out_bits = length_bytes * 8;
                    if (nframes < meta_cap_frames &&
                        payload_off + out_bits <= payload_cap) {
                        for (int j = 0; j < length_bytes; j++)
                            for (int bi = 0; bi < 8; bi++)
                                payload_out[payload_off + j * 8 + bi] =
                                    d->buffer[j * 8 + (7 - bi)];
                        meta[4 * nframes + 0] = 0;
                        meta[4 * nframes + 1] = plen;
                        meta[4 * nframes + 2] = 1;
                        meta[4 * nframes + 3] = payload_off;
                        payload_off += out_bits;
                        nframes++;
                    }
                } else {
                    d->lostframes++;
                }
            } else {
                d->lostframes2++;
            }
            hdlc_reset(d);
            break;
        }
        }
        d->last = (int32_t)b;
    }
    return nframes;
}

int hdlc_state_size() { return (int)sizeof(HdlcState); }

}  // extern "C"
