// One stream's decode step: exact FIR, DPLL slicer with NRZI, and the
// HDLC deframer with its 15x32-bit register.
//
// Shared between the CUDA kernels (pipeline_kernel.cuh, frontend.cu,
// dpll.cu, roofline.cu) and a later CPU build, so every function is __host__
// __device__ and the state lives in plain structs.  Bit-exact with the
// exact chain of gnuais_tpu (ops/fir.fir_exact, ops/demod.dpll_scan /
// group_reduce_bits / hdlc_scan): the FIR rounds every product and every
// partial sum to float32 once, in tap order, with no fused multiply-add;
// subnormals are kept, as in the reference C receiver.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GNUAIS_HD __host__ __device__ __forceinline__
#else
#define GNUAIS_HD inline
#endif

namespace gnuais {

constexpr int kFirLen = 36;
constexpr int kRegWords = 15;
constexpr int kHdlcChunk = 64;   // bit slots per deframer chunk
constexpr int kMiniSlots = 2;    // completions kept per chunk

constexpr int kPllCenter = 0x8000;
constexpr int kPllInc = 13107;   // 0x10000 / 5
constexpr int kPllNudge = 819;   // kPllInc / 16

constexpr int kStSkurr = 1;
constexpr int kStPreamble = 2;
constexpr int kStStartsign = 3;
constexpr int kStData = 4;
constexpr int kStStopsign = 5;
constexpr int kMaxFrameDataBits = 449;
constexpr int kFrameTailBits = 22;

// The 36 taps as exact float32 values (gnuais_tpu/constants.py FIR_TAPS
// after its float32 cast; a CPU test checks these literals bit for bit).
// Taps 2 and 33 are subnormal.
#define GNUAIS_FIR_TAPS                                                   \
  0x0.0p+0f, 0x0.0p+0f, 0x1.a4p-143f, 0x1.617adap-125f,                 \
  0x1.05868ep-108f, 0x1.54d20ep-93f, 0x1.873066p-79f, 0x1.8b6e9cp-66f,  \
  0x1.600d3p-54f, 0x1.140c52p-43f, 0x1.7d4444p-34f, 0x1.cfc9aap-26f,    \
  0x1.f0dfcp-19f, 0x1.d4d17ep-13f, 0x1.859932p-8f, 0x1.1d25aap-4f,      \
  0x1.6f9b14p-2f, 0x1.a16484p-1f, 0x1.a16484p-1f, 0x1.6f9b14p-2f,       \
  0x1.1d25aap-4f, 0x1.859932p-8f, 0x1.d4d17ep-13f, 0x1.f0dfcp-19f,      \
  0x1.cfc9aap-26f, 0x1.7d4444p-34f, 0x1.140c52p-43f, 0x1.600d3p-54f,    \
  0x1.8b6e9cp-66f, 0x1.873066p-79f, 0x1.54d20ep-93f, 0x1.05868ep-108f,  \
  0x1.617adap-125f, 0x1.a4p-143f, 0x0.0p+0f, 0x0.0p+0f

GNUAIS_HD float fmul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);   // never contracted into an FMA
#else
  return a * b;             // host build: -ffp-contract=off
#endif
}

GNUAIS_HD float fadd_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// FIR output for the window win[0..35] (win[35] the newest sample): the
// one-sample delay means the sample being filtered is not in its own sum.
GNUAIS_HD float fir_exact(const float (&win)[kFirLen]) {
  constexpr float taps[kFirLen] = {GNUAIS_FIR_TAPS};
  float f = fmul_rn(win[0], taps[0]);
#pragma unroll
  for (int i = 1; i < kFirLen; ++i) f = fadd_rn(f, fmul_rn(win[i], taps[i]));
  return f;
}

// Main-lobe FIR (gnuais_tpu/ops/fused.py fir_mode="lobe"): only taps
// LOBE_LO..LOBE_HI = 10..25, the mirrored samples of each symmetric tap
// pair added first, the eight pair terms accumulated from tap 10 up.
// Not the exact chain's rounding (a packet-parity mode in the JAX
// package); the plain version ops/fir.fir_lobe repeats this order.
constexpr int kLobeLo = 10;
constexpr int kLobeHi = 25;

GNUAIS_HD float fir_lobe(const float (&win)[kFirLen]) {
  constexpr float taps[kFirLen] = {GNUAIS_FIR_TAPS};
  float f = fmul_rn(fadd_rn(win[kLobeLo], win[kFirLen - 1 - kLobeLo]),
                    taps[kLobeLo]);
#pragma unroll
  for (int i = kLobeLo + 1; i < (kLobeLo + kLobeHi + 1) / 2; ++i)
    f = fadd_rn(f, fmul_rn(fadd_rn(win[i], win[kFirLen - 1 - i]), taps[i]));
  return f;
}

// fir_exact and fir_lobe of the 36 samples win[k .. k + 35] of a longer
// window (a 32-sample chunk's, pipeline_ring.cuh), in the same order
// with the same rounding, so bitwise equal to them.  Called with k a
// constant of an unrolled loop, so that the window stays in registers.
template <int kWin>
GNUAIS_HD float fir_exact_at(const float (&win)[kWin], int k) {
  constexpr float taps[kFirLen] = {GNUAIS_FIR_TAPS};
  float f = fmul_rn(win[k], taps[0]);
#pragma unroll
  for (int i = 1; i < kFirLen; ++i) f = fadd_rn(f, fmul_rn(win[k + i], taps[i]));
  return f;
}

template <int kWin>
GNUAIS_HD float fir_lobe_at(const float (&win)[kWin], int k) {
  constexpr float taps[kFirLen] = {GNUAIS_FIR_TAPS};
  float f = fmul_rn(fadd_rn(win[k + kLobeLo], win[k + kFirLen - 1 - kLobeLo]),
                    taps[kLobeLo]);
#pragma unroll
  for (int i = kLobeLo + 1; i < (kLobeLo + kLobeHi + 1) / 2; ++i)
    f = fadd_rn(f, fmul_rn(fadd_rn(win[k + i], win[k + kFirLen - 1 - i]),
                           taps[i]));
  return f;
}

struct DpllRegs {
  int32_t pll, prev, lastbit;
};

// One sliced sample (curr: 1 above zero, else 0) through the DPLL.
// Returns true on a bit emission and sets *bit to the NRZI-decoded bit.
GNUAIS_HD bool dpll_step_sliced(DpllRegs& d, int32_t curr, int32_t* bit) {
  const int32_t trans = curr ^ d.prev;
  const int32_t nudge = d.pll < kPllCenter ? kPllNudge : -kPllNudge;
  const int32_t adv = d.pll + trans * nudge + kPllInc;   // in [0, 2^17)
  const bool emit = adv > 0xFFFF;
  *bit = 1 - (curr ^ d.lastbit);
  d.pll = adv & 0xFFFF;
  if (emit) d.lastbit = curr;
  d.prev = curr;
  return emit;
}

// One filtered sample through the slicer and the DPLL.
GNUAIS_HD bool dpll_step(DpllRegs& d, float f, int32_t* bit) {
  return dpll_step_sliced(d, f > 0.0f ? 1 : 0, bit);
}

struct HdlcRegs {
  int32_t state, last, ap, ns, ae, bs, bp, ds;
  uint32_t reg[kRegWords];   // newest bit = LSB of reg[14]
};

GNUAIS_HD void reg_append(uint32_t (&reg)[kRegWords], uint32_t b) {
#pragma unroll
  for (int w = 0; w < kRegWords - 1; ++w) reg[w] = (reg[w] << 1) | (reg[w + 1] >> 31);
  reg[kRegWords - 1] = (reg[kRegWords - 1] << 1) | b;
}

// What one valid bit slot did besides updating the state.
struct SlotEvent {
  bool emit;      // a frame of positive length completed; its register
                  // snapshot is h.reg as it stands after the call (a stop
                  // slot never appends)
  bool bad;       // a wrong-size stop flag
  int32_t flen;   // payload bits of the completed frame
  int32_t start;  // sample index of its data start
};

// One valid bit slot through the deframer (the reference's per-bit
// switch, protodec.c:993-1121, as ops/demod.hdlc_scan derives it).
// b is the slot's bit, spos its absolute sample index.  kAppend false
// leaves the register out (the roofline tool's "dpll+hdlc" mode); the
// state update never reads it.
template <bool kAppend = true>
GNUAIS_HD SlotEvent hdlc_step(HdlcRegs& h, int32_t b, int32_t spos) {
  SlotEvent ev{false, false, 0, 0};
  const bool b1 = b == 1;
  const bool alt = b != h.last;
  switch (h.state) {
    case kStData:
      if (h.bs == 1) {
        // stuffed position: a one is the stop flag, a zero is dropped
        h.bs = 0;
        if (b1) h.state = kStStopsign;
      } else {
        const int32_t ae_new = (b1 && h.last == 1) ? h.ae + 1 : 0;
        const bool set_stuff = ae_new == 4;
        if constexpr (kAppend) reg_append(h.reg, static_cast<uint32_t>(b));
        if (h.bp + 1 >= kMaxFrameDataBits) {
          h.state = kStSkurr;
          h.ap = h.ns = h.ae = h.bs = h.bp = 0;
        } else {
          h.ae = set_stuff ? 0 : ae_new;
          h.bs = set_stuff ? 1 : 0;
          h.bp += 1;
        }
      }
      break;
    case kStSkurr: {
      const int32_t ap = alt ? h.ap + 1 : 0;
      if (ap > 14 && !b1) {
        h.state = kStPreamble;
        h.ap = 0;
      } else {
        h.ap = ap;
      }
      break;
    }
    case kStPreamble:
      if (alt && h.ns == 0) {
        h.ap += 1;
      } else if (b1) {
        if (h.ns == 5) {
          h.state = kStStartsign;
          h.ap = 0;
          h.ns = 6;
        } else {
          h.ns = h.ns == 0 ? 3 : h.ns + 1;
        }
      } else if (h.ns != 0) {
        h.state = kStSkurr;
        h.ap = h.ns = h.ae = h.bs = h.bp = 0;
      } else {
        h.ns = 1;
      }
      break;
    case kStStartsign: {
      const bool ge7 = h.ns >= 7;
      if (ge7 && !b1) {
        h.state = kStData;
        h.ns = 1;
        h.ae = h.bp = 0;
        h.ds = spos;
      } else if (ge7 == b1) {
        h.state = kStSkurr;
        h.ns = 1;
        h.ap = h.ae = h.bs = h.bp = 0;
      } else {
        h.ns += 1;
      }
      break;
    }
    default: {  // kStStopsign: always a full reset afterwards
      const int32_t flen = h.bp - kFrameTailBits;
      const bool good = !b1 && flen > 0;
      ev.emit = good;
      ev.bad = !good;
      ev.flen = flen;
      ev.start = h.ds;
      h.state = kStSkurr;
      h.ap = h.ns = h.ae = h.bs = h.bp = 0;
      break;
    }
  }
  h.last = b;
  return ev;
}

}  // namespace gnuais
