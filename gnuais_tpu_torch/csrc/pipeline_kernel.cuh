// One stream of the fused decode kernel, shared by kernels B1
// (pipeline_compact.cu) and B2 (pipeline_fused.cu).
//
// Replaces the body of the TPU kernel gnuais_tpu/ops/fused.py
// `_pipeline_kernel`, which serves both of its wrappers through
// `compact_slots`: raw int16 samples -> 36-tap FIR (one-sample delay,
// carried history) -> DPLL slicer + NRZI -> 4-sample bit slots -> HDLC
// deframer -> completed frames, plus the new DPLL and HDLC carry.
//
// Two compile-time choices:
// - the FIR: Fir::kExact (fir_mode "vpu", the exact chain's rounding) or
//   Fir::kLobe (fir_mode "lobe", taps 10..25 in symmetric pairs);
// - the landing of a completed frame: dense (B1, at the stream's running
//   count in F slots) or candidates (B2, at slot c*2 + n of its 64-slot
//   chunk c, n the completions the chunk held before it, which
//   demod.compact_candidates then compacts).
// Either way a completion is kept while its chunk has held fewer than
// kMiniSlots completions, as in the exact chain (structurally always:
// completions are >= ~47 slots apart); a later one in the same chunk is
// counted in `over` instead.
//
// What bounds it on an H100: each stream is a long sequential chain (36
// float multiply-adds, or 23 float operations for the lobe FIR, ~10
// integer ops of DPLL per sample and a branchy deframer step every 4
// samples) with no parallelism inside the stream, so a thread waits on
// its chain and its loads, far from the card's bandwidth or FLOP rate.
// Design: one thread per stream, all state in registers (the 36-float
// window shifted with static indices, the DPLL and HDLC variables, the
// 15-word register); time-major [T, S] input so a warp's 32 loads at one
// time step are neighbouring.  Frames are rare (tens per stream per
// block), so each is written straight to global memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace gnuais {

enum class Fir { kExact, kLobe };

// Pointers and sizes of one launch; the layouts are the wrappers' in
// gnuais_tpu_torch/ops/fused.py.
struct PipelineArgs {
  const int16_t* x;        // [T, S]
  const float* hist;       // [S, 36]
  const int32_t* dpll_in;  // [3, S]: pll, prev, lastbit
  const int32_t* hdlc_in;  // [8, S]: HdlcState order
  const int32_t* reg_in;   // [S, 15] uint32 bit patterns
  int32_t* count_raw;      // [S] (dense landing only)
  uint8_t* cand_valid;     // [S, slots] bool (candidate landing only)
  int32_t* words;          // [S, slots, 15], zero-filled
  int32_t* fields;         // [3, S, slots]: length, start, end, zero-filled
  int32_t* lost2;          // [S]
  int32_t* over;           // [S]
  int32_t* dpll_out;       // [3, S]
  int32_t* hdlc_out;       // [8, S]
  int32_t* reg_out;        // [S, 15]
  int S, T, n_valid, block_base, lost2_lo, lost2_hi;
  int slots;               // F (dense) or K = 2 * ceil(T / 256) (candidates)
};

template <Fir kFir>
__device__ __forceinline__ float fir(const float (&win)[kFirLen]) {
  if constexpr (kFir == Fir::kLobe) {
    return fir_lobe(win);
  } else {
    return fir_exact(win);
  }
}

// `a` by value, not by reference: a reference to the kernel's parameter
// made every kernel ~8 % slower on an H100 (B1: 24.3 against 22.4 ms
// per 4096 x 49,152 block).
template <Fir kFir, bool kCandidates>
__device__ __forceinline__ void pipeline_stream(const PipelineArgs a, int s) {
  const int S = a.S;
  float win[kFirLen];
#pragma unroll
  for (int i = 0; i < kFirLen; ++i) win[i] = a.hist[(size_t)s * kFirLen + i];
  DpllRegs d{a.dpll_in[s], a.dpll_in[S + s], a.dpll_in[2 * S + s]};
  HdlcRegs h;
  h.state = a.hdlc_in[s];
  h.last = a.hdlc_in[S + s];
  h.ap = a.hdlc_in[2 * S + s];
  h.ns = a.hdlc_in[3 * S + s];
  h.ae = a.hdlc_in[4 * S + s];
  h.bs = a.hdlc_in[5 * S + s];
  h.bp = a.hdlc_in[6 * S + s];
  h.ds = a.hdlc_in[7 * S + s];
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    h.reg[w] = static_cast<uint32_t>(a.reg_in[(size_t)s * kRegWords + w]);

  int32_t count = 0, lost2 = 0, over = 0, chunk_count = 0;
  const int nv = a.n_valid < a.T ? a.n_valid : a.T;  // samples past n_valid freeze
  const int n_groups = nv > 0 ? (nv + 3) / 4 : 0;
  for (int g = 0; g < n_groups; ++g) {
    if (g % kHdlcChunk == 0) chunk_count = 0;
    bool gval = false;
    int32_t gbit = 0, gpos = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * g + k;
      if (t < nv) {
        const float f = fir<kFir>(win);
#pragma unroll
        for (int i = 0; i < kFirLen - 1; ++i) win[i] = win[i + 1];
        // read-only path, as a const __restrict__ parameter would give
        win[kFirLen - 1] = static_cast<float>(__ldg(a.x + (size_t)t * S + s));
        int32_t bit;
        if (dpll_step(d, f, &bit)) {   // at most one emission per group
          gval = true;
          gbit = bit;
          gpos = static_cast<int32_t>(static_cast<uint32_t>(a.block_base) +
                                      static_cast<uint32_t>(t));
        }
      }
    }
    if (!gval) continue;
    const SlotEvent ev = hdlc_step(h, gbit, gpos);
    if (ev.bad && gpos >= a.lost2_lo && gpos < a.lost2_hi) ++lost2;
    if (ev.emit) {
      if (chunk_count < kMiniSlots) {
        // dense: the running count, while it fits the F slots;
        // candidates: the chunk's own slot, always inside K
        const int slot = kCandidates
            ? (g / kHdlcChunk) * kMiniSlots + chunk_count : count;
        if (slot < a.slots) {
          const size_t at = (size_t)s * a.slots + slot;
          int32_t* dst = a.words + at * kRegWords;
#pragma unroll
          for (int w = 0; w < kRegWords; ++w) dst[w] = static_cast<int32_t>(h.reg[w]);
          const size_t plane = (size_t)S * a.slots;
          a.fields[at] = ev.flen;
          a.fields[plane + at] = ev.start;
          a.fields[2 * plane + at] = gpos;
          if constexpr (kCandidates) a.cand_valid[at] = 1;
        }
        ++count;
      } else {
        ++over;
      }
      ++chunk_count;
    }
  }

  if constexpr (!kCandidates) a.count_raw[s] = count;
  a.lost2[s] = lost2;
  a.over[s] = over;
  a.dpll_out[s] = d.pll;
  a.dpll_out[S + s] = d.prev;
  a.dpll_out[2 * S + s] = d.lastbit;
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

// The kernel of both entry points: one thread per stream.
template <Fir kFir, bool kCandidates>
__global__ void __launch_bounds__(128) pipeline_kernel(const PipelineArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < a.S) pipeline_stream<kFir, kCandidates>(a, s);
}

constexpr int kPipelineThreads = 128;

// Launches pipeline_kernel<fir_mode, kCandidates> on `stream`
// (fir_mode 0 = exact, 1 = lobe) and returns cudaGetLastError(), so a
// refused launch, or an unknown mode, is reported to the caller.
template <bool kCandidates>
int launch_pipeline(const PipelineArgs& a, int fir_mode, void* stream) {
  const int blocks = (a.S + kPipelineThreads - 1) / kPipelineThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fir_mode == 0) {
    pipeline_kernel<Fir::kExact, kCandidates><<<blocks, kPipelineThreads, 0, st>>>(a);
  } else if (fir_mode == 1) {
    pipeline_kernel<Fir::kLobe, kCandidates><<<blocks, kPipelineThreads, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnuais
