// Kernels R1 and R2: the per-sample recurrence of the fused decode
// kernel alone, to measure its chain latency on the card.
//
// Replace the TPU kernels of tools/roofline.py: R1 `make_chain_kernel`
// (the chain fed by an LCG, nothing read per step) and R2
// `_make_streamed_kernel` (the chain fed by a streamed int16 input).
// Both run the step functions of pipeline_step.cuh, one thread per
// stream with all state in registers, as kernels B1 and B2 do:
// - the DPLL slicer and NRZI every sample;
// - with "hdlc", every 4 samples the group's bit slot through the
//   deframer at spos = the index of the group's last sample (R2: within
//   its 512-sample chunk, as the TPU kernel's grid step restarts it);
// - with "shift", the deframer's register appends too.
// R2 adds, per mode: "fir" the lobe FIR over a 36-float window in
// registers (history from zero, carried across chunks and passes);
// "blocks" 16 dummy int32 [S] carry arrays read and written once per
// 512-sample chunk, as the TPU kernel's per-grid-step carry blocks were.
// R2 loops `passes` times over the same [steps, S] input.
//
// What bounds them: R1 moves no bytes; its bound is the integer
// operations of a step at the card's 32-bit rate, and a thread waits on
// its own chain, so at few streams a kernel sits far above that bound
// and the time a step takes is the chain's latency.  R2 reads 2 bytes a
// sample a pass.  Every output is written (the final PLL, and with
// "hdlc" the deframer's state and register), so nvcc cannot delete the
// work as dead code; the dummy blocks go through volatile accesses for
// the same reason.  The LCG runs in uint32: signed overflow is
// undefined in C++, and JAX's int32 wraps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace {

using namespace gnuais;

constexpr int kThreads = 128;
constexpr int kChunk = 512;      // R2: samples per TPU grid step
constexpr int kDummy = 16;       // R2 "blocks": carry arrays per chunk

struct RoofArgs {
  const int32_t* seed;           // R1: [S] LCG seeds
  const int16_t* x;              // R2: [steps, S]
  const int32_t* dummy_in;       // R2: [16, S]
  int32_t* dummy_out;            // R2: [16, S]
  int32_t* pll_out;              // [S]
  int32_t* hdlc_out;             // [8, S]: HdlcState order
  int32_t* reg_out;              // [S, 15]
  int S, steps, passes;
};

// The deframer's state at the start of a capture (ops/demod.init_hdlc).
__device__ __forceinline__ HdlcRegs initial_hdlc() {
  HdlcRegs h{};
  h.state = kStSkurr;
  return h;
}

__device__ __forceinline__ void store(const RoofArgs& a, int s,
                                      const DpllRegs& d, const HdlcRegs& h,
                                      bool with_hdlc) {
  a.pll_out[s] = d.pll;
  if (!with_hdlc) return;
  const int S = a.S;
  a.hdlc_out[s] = h.state;
  a.hdlc_out[S + s] = h.last;
  a.hdlc_out[2 * S + s] = h.ap;
  a.hdlc_out[3 * S + s] = h.ns;
  a.hdlc_out[4 * S + s] = h.ae;
  a.hdlc_out[5 * S + s] = h.bs;
  a.hdlc_out[6 * S + s] = h.bp;
  a.hdlc_out[7 * S + s] = h.ds;
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    a.reg_out[(size_t)s * kRegWords + w] = static_cast<int32_t>(h.reg[w]);
}

// R1: kHdlc / kShift select "dpll", "dpll+hdlc", "dpll+hdlc+shift".
template <bool kHdlc, bool kShift>
__global__ void __launch_bounds__(kThreads) chain_kernel(const RoofArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.S) return;
  uint32_t lcg = static_cast<uint32_t>(a.seed[s]);
  DpllRegs d{0, 0, 0};
  HdlcRegs h = initial_hdlc();
  for (int g = 0; g < a.steps / 4; ++g) {
    bool gval = false;
    int32_t gbit = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // 2-op stand-in for the filtered sample: its sign
      lcg = lcg * 1103515245u + 12345u;
      int32_t bit;
      if (dpll_step_sliced(d, static_cast<int32_t>(lcg) > 0 ? 1 : 0, &bit)) {
        gval = true;
        gbit = bit;
      }
    }
    if constexpr (kHdlc) {
      if (gval) hdlc_step<kShift>(h, gbit, 4 * g + 3);
    }
  }
  store(a, s, d, h, kHdlc);
}

// R2: kHdlc / kShift as R1's, kFir the lobe FIR, kBlocks the dummy
// carry arrays.
template <bool kHdlc, bool kShift, bool kFir, bool kBlocks>
__global__ void __launch_bounds__(kThreads) stream_kernel(const RoofArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.S) return;
  const int S = a.S;
  DpllRegs d{0, 0, 0};
  HdlcRegs h = initial_hdlc();
  float win[kFirLen];
#pragma unroll
  for (int i = 0; i < kFirLen; ++i) win[i] = 0.0f;
  const volatile int32_t* din = a.dummy_in;
  volatile int32_t* dout = a.dummy_out;
  for (int p = 0; p < a.passes; ++p) {
    for (int c = 0; c < a.steps / kChunk; ++c) {
      int32_t carry[kDummy];
      if constexpr (kBlocks) {
#pragma unroll
        for (int j = 0; j < kDummy; ++j) carry[j] = din[(size_t)j * S + s];
      }
      const int16_t* xc = a.x + (size_t)c * kChunk * S + s;
      for (int g = 0; g < kChunk / 4; ++g) {
        bool gval = false;
        int32_t gbit = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = static_cast<float>(__ldg(xc + (size_t)(4 * g + k) * S));
          float f = v;
          if constexpr (kFir) {
            f = fir_lobe(win);
#pragma unroll
            for (int i = 0; i < kFirLen - 1; ++i) win[i] = win[i + 1];
            win[kFirLen - 1] = v;
          }
          int32_t bit;
          if (dpll_step(d, f, &bit)) {
            gval = true;
            gbit = bit;
          }
        }
        if constexpr (kHdlc) {
          if (gval) hdlc_step<kShift>(h, gbit, 4 * g + 3);
        }
      }
      if constexpr (kBlocks) {
#pragma unroll
        for (int j = 0; j < kDummy; ++j) dout[(size_t)j * S + s] = carry[j];
      }
    }
  }
  store(a, s, d, h, kHdlc);
}

int launched(void (*kernel)(RoofArgs), const RoofArgs& a, void* stream) {
  const int blocks = (a.S + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R1.  mode: 0 "dpll", 1 "dpll+hdlc", 2 "dpll+hdlc+shift".  Returns
// cudaGetLastError() after the launch (an unknown mode:
// cudaErrorInvalidValue).
extern "C" int gnuais_roofline_chain(const void* seed, void* pll_out,
                                     void* hdlc_out, void* reg_out, int S,
                                     int steps, int mode, void* stream) {
  RoofArgs a{static_cast<const int32_t*>(seed), nullptr, nullptr, nullptr,
             static_cast<int32_t*>(pll_out), static_cast<int32_t*>(hdlc_out),
             static_cast<int32_t*>(reg_out), S, steps, 1};
  switch (mode) {
    case 0: return launched(chain_kernel<false, false>, a, stream);
    case 1: return launched(chain_kernel<true, false>, a, stream);
    case 2: return launched(chain_kernel<true, true>, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// R2.  mode: the bits 1 "hdlc", 2 "shift", 4 "fir", 8 "blocks"; the
// four combinations of tools/roofline.py: 0 "stream+dpll",
// 3 "stream+dpll+hdlc+shift", 7 "stream+fir+dpll+hdlc+shift",
// 11 "stream+blocks+dpll+hdlc+shift".  steps % 512 == 0.
extern "C" int gnuais_roofline_stream(const void* x, const void* dummy_in,
                                      void* dummy_out, void* pll_out,
                                      void* hdlc_out, void* reg_out, int S,
                                      int steps, int passes, int mode,
                                      void* stream) {
  RoofArgs a{nullptr, static_cast<const int16_t*>(x),
             static_cast<const int32_t*>(dummy_in),
             static_cast<int32_t*>(dummy_out), static_cast<int32_t*>(pll_out),
             static_cast<int32_t*>(hdlc_out), static_cast<int32_t*>(reg_out),
             S, steps, passes};
  switch (mode) {
    case 0: return launched(stream_kernel<false, false, false, false>, a, stream);
    case 3: return launched(stream_kernel<true, true, false, false>, a, stream);
    case 7: return launched(stream_kernel<true, true, true, false>, a, stream);
    case 11: return launched(stream_kernel<true, true, false, true>, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
