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
// - the FIR: Fir::kExact (fir_mode "vpu", the exact chain's rounding),
//   Fir::kLobe (fir_mode "lobe", taps 10..25 in symmetric pairs) or
//   Fir::kMxu (fir_mode "mxu", fused.py:735-747, 767-768, 902-903: a
//   banded matrix product per 32-sample chunk on the tensor cores,
//   fir_mxu.cuh);
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
// block), so each is written straight to global memory.  In the mxu
// mode the FIR leaves the chain: the warp filters a 32-sample chunk of
// its 32 streams in one product, each chunk's 32 loads issued together
// before it, and every lane then runs the same per-sample DPLL and
// per-group deframer over its 32 values in shared memory; the control
// flow stays warp-uniform up to the product, which needs all 32 lanes.
// The vpu FIR keeps its FMA-free rounding (__fmul_rn, __fadd_rn).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mxu.cuh"
#include "pipeline_step.cuh"

namespace gnuais {

enum class Fir { kExact, kLobe, kMxu };

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

// A stream's DPLL and HDLC carry and its frame book-keeping.
struct StreamRegs {
  DpllRegs d;
  HdlcRegs h;
  int32_t count, lost2, over, chunk_count;
};

__device__ __forceinline__ void load_carry(const PipelineArgs& a, int s,
                                           StreamRegs& r) {
  const int S = a.S;
  r.d = DpllRegs{a.dpll_in[s], a.dpll_in[S + s], a.dpll_in[2 * S + s]};
  r.h.state = a.hdlc_in[s];
  r.h.last = a.hdlc_in[S + s];
  r.h.ap = a.hdlc_in[2 * S + s];
  r.h.ns = a.hdlc_in[3 * S + s];
  r.h.ae = a.hdlc_in[4 * S + s];
  r.h.bs = a.hdlc_in[5 * S + s];
  r.h.bp = a.hdlc_in[6 * S + s];
  r.h.ds = a.hdlc_in[7 * S + s];
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    r.h.reg[w] = static_cast<uint32_t>(a.reg_in[(size_t)s * kRegWords + w]);
  r.count = r.lost2 = r.over = r.chunk_count = 0;
}

// Group g's bit slot (gval: a bit was emitted, gbit at sample gpos)
// through the deframer, and a completed frame landed in its slot.
template <bool kCandidates>
__device__ __forceinline__ void slot_step(const PipelineArgs& a, int s,
                                          int g, bool gval, int32_t gbit,
                                          int32_t gpos, StreamRegs& r) {
  if (g % kHdlcChunk == 0) r.chunk_count = 0;
  if (!gval) return;
  const SlotEvent ev = hdlc_step(r.h, gbit, gpos);
  if (ev.bad && gpos >= a.lost2_lo && gpos < a.lost2_hi) ++r.lost2;
  if (ev.emit) {
    if (r.chunk_count < kMiniSlots) {
      // dense: the running count, while it fits the F slots;
      // candidates: the chunk's own slot, always inside K
      const int slot = kCandidates
          ? (g / kHdlcChunk) * kMiniSlots + r.chunk_count : r.count;
      if (slot < a.slots) {
        const size_t at = (size_t)s * a.slots + slot;
        int32_t* dst = a.words + at * kRegWords;
#pragma unroll
        for (int w = 0; w < kRegWords; ++w) dst[w] = static_cast<int32_t>(r.h.reg[w]);
        const size_t plane = (size_t)a.S * a.slots;
        a.fields[at] = ev.flen;
        a.fields[plane + at] = ev.start;
        a.fields[2 * plane + at] = gpos;
        if constexpr (kCandidates) a.cand_valid[at] = 1;
      }
      ++r.count;
    } else {
      ++r.over;
    }
    ++r.chunk_count;
  }
}

template <bool kCandidates>
__device__ __forceinline__ void store_carry(const PipelineArgs& a, int s,
                                            const StreamRegs& r) {
  const int S = a.S;
  if constexpr (!kCandidates) a.count_raw[s] = r.count;
  a.lost2[s] = r.lost2;
  a.over[s] = r.over;
  a.dpll_out[s] = r.d.pll;
  a.dpll_out[S + s] = r.d.prev;
  a.dpll_out[2 * S + s] = r.d.lastbit;
  a.hdlc_out[s] = r.h.state;
  a.hdlc_out[S + s] = r.h.last;
  a.hdlc_out[2 * S + s] = r.h.ap;
  a.hdlc_out[3 * S + s] = r.h.ns;
  a.hdlc_out[4 * S + s] = r.h.ae;
  a.hdlc_out[5 * S + s] = r.h.bs;
  a.hdlc_out[6 * S + s] = r.h.bp;
  a.hdlc_out[7 * S + s] = r.h.ds;
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    a.reg_out[(size_t)s * kRegWords + w] = static_cast<int32_t>(r.h.reg[w]);
}

// One sample's filtered value f, at t, through the DPLL into its group's
// slot (at most one emission per 4-sample group).
__device__ __forceinline__ void sample_step(const PipelineArgs& a,
                                            StreamRegs& r, float f, int t,
                                            bool& gval, int32_t& gbit,
                                            int32_t& gpos) {
  int32_t bit;
  if (dpll_step(r.d, f, &bit)) {
    gval = true;
    gbit = bit;
    gpos = static_cast<int32_t>(static_cast<uint32_t>(a.block_base) +
                                static_cast<uint32_t>(t));
  }
}

// `a` by value, not by reference: a reference to the kernel's parameter
// made every kernel ~8 % slower on an H100 (B1: 24.3 against 22.4 ms
// per 4096 x 49,152 block).  The FIR modes vpu and lobe: the window in
// registers, one sample loaded per step.
template <Fir kFir, bool kCandidates>
__device__ __forceinline__ void pipeline_stream(const PipelineArgs a, int s) {
  float win[kFirLen];
#pragma unroll
  for (int i = 0; i < kFirLen; ++i) win[i] = a.hist[(size_t)s * kFirLen + i];
  StreamRegs r;
  load_carry(a, s, r);
  const int nv = a.n_valid < a.T ? a.n_valid : a.T;  // samples past n_valid freeze
  const int n_groups = nv > 0 ? (nv + 3) / 4 : 0;
  for (int g = 0; g < n_groups; ++g) {
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
        win[kFirLen - 1] = static_cast<float>(__ldg(a.x + (size_t)t * a.S + s));
        sample_step(a, r, f, t, gval, gbit, gpos);
      }
    }
    slot_step<kCandidates>(a, s, g, gval, gbit, gpos, r);
  }
  store_carry<kCandidates>(a, s, r);
}

// The mxu FIR mode (fir_mxu.cuh, mxu_chunks): per 32-sample chunk, every
// lane of the warp stages its stream's samples, the warp runs the banded
// product, and each lane runs the chain above over its 32 filtered
// values (8 groups).  The chunk count follows the scalar n_valid, so
// the control flow is the same on every lane up to the product; a lane
// past the last stream (s >= S) stages zeros, takes part in the product
// and writes nothing.
template <bool kCandidates>
__device__ __forceinline__ void pipeline_stream_mxu(const PipelineArgs a,
                                                    int s, const MxuBand& band,
                                                    MxuWarp& w) {
  const bool live = s < a.S;
  StreamRegs r;
  if (live) load_carry(a, s, r);
  const int nv = a.n_valid < a.T ? a.n_valid : a.T;
  mxu_chunks(band, w, a.x, a.S, a.T, nv, live ? s : -1,
             live ? a.hist + (size_t)s * kFirLen : nullptr,
             [&](int t0, const float* f) {
#pragma unroll 1
    for (int q = 0; q < kMxuUnroll / 4; ++q) {
      const int g = t0 / 4 + q;
      bool gval = false;
      int32_t gbit = 0, gpos = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * g + k;
        if (t < nv) sample_step(a, r, f[(4 * q + k) * kMxuLd], t, gval, gbit, gpos);
      }
      if (4 * g < nv) slot_step<kCandidates>(a, s, g, gval, gbit, gpos, r);
    }
  });
  if (live) store_carry<kCandidates>(a, s, r);
}

constexpr int kPipelineThreads = 128;

// The kernel of both entry points: one thread per stream.
template <Fir kFir, bool kCandidates>
__global__ void __launch_bounds__(kPipelineThreads) pipeline_kernel(const PipelineArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kFir == Fir::kMxu) {
    unsigned char* smem = mxu_shared();
    MxuBand& band = *reinterpret_cast<MxuBand*>(smem);
    MxuWarp* warps = reinterpret_cast<MxuWarp*>(smem + sizeof(MxuBand));
    mxu_band_init(band);
    __syncthreads();
    pipeline_stream_mxu<kCandidates>(a, s, band, warps[threadIdx.x / 32]);
  } else {
    if (s < a.S) pipeline_stream<kFir, kCandidates>(a, s);
  }
}

// Launches pipeline_kernel<fir_mode, kCandidates> on `stream`
// (fir_mode 0 = exact, 1 = lobe, 2 = mxu) and returns cudaGetLastError(),
// so a refused launch, or an unknown mode, is reported to the caller.
template <bool kCandidates>
int launch_pipeline(const PipelineArgs& a, int fir_mode, void* stream) {
  const int blocks = (a.S + kPipelineThreads - 1) / kPipelineThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fir_mode == 0) {
    pipeline_kernel<Fir::kExact, kCandidates><<<blocks, kPipelineThreads, 0, st>>>(a);
  } else if (fir_mode == 1) {
    pipeline_kernel<Fir::kLobe, kCandidates><<<blocks, kPipelineThreads, 0, st>>>(a);
  } else if (fir_mode == 2) {
    // above 48 KB a block's dynamic shared memory must be asked for
    constexpr size_t smem = mxu_shared_bytes(kPipelineThreads);
    const cudaError_t err = cudaFuncSetAttribute(
        pipeline_kernel<Fir::kMxu, kCandidates>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pipeline_kernel<Fir::kMxu, kCandidates><<<blocks, kPipelineThreads, smem, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnuais
