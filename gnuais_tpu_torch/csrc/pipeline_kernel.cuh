// The fused decode kernel shared by kernels B1 (pipeline_compact.cu) and
// B2 (pipeline_fused.cu).
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
// What bounds it on an H100: each stream is one long sequential chain
// (~10 integer operations of DPLL a sample and a branchy deframer step
// every 4 samples) with no parallelism inside the stream; the roofline
// kernel R1 (roofline.cu) runs that chain alone at ~33 ns a sample, 1.6
// ms for 4096 x 49,152.  The FIR (71 float operations a sample exact, 23
// lobe, 216 TF32 in mxu) and the loads do not depend on the chain.
//
// Design: warp specialisation around a ring of filtered chunks in
// shared memory (pipeline_ring.cuh).  A block serves 32 streams with
// one consumer warp (warp 0) and P producer warps:
// - the consumer, one lane a stream, runs only the recurrence (DPLL
//   sample_step per sample, slot_step per 4-sample group), its state in
//   registers, reading each chunk's 32 filtered values from its ring
//   stage;
// - producer p filters chunks p, p + P, ...: it copies the chunk's raw
//   window (cp.async where aligned; the input time-major [T, S] or
//   row-major [S, T], as the caller holds it), issues the next chunk's
//   copy, and writes the 32 x 32 filtered values into the chunk's stage:
//   fir_exact_at / fir_lobe_at over a 72-float window in registers
//   (FMA-free, __fmul_rn/__fadd_rn, so bitwise the exact chain's), or
//   the 3xTF32 product of fir_mxu.cuh;
// - full/empty mbarriers per stage, kStages = 4 >= P + 1.
// Lanes past the last stream (s >= S) filter zeros and write nothing.
// Frames are rare (tens per stream per block), so each is written
// straight to global memory.
//
// Chosen per FIR mode (fused.pipeline_shape reads them back; registers
// per thread as nvcc -Xptxas -v gives them for sm_90a, in the log beside
// the built library): vpu P = 3, lobe P = 2, mxu P = 3, kStages = 4;
// blocks of 128, 96 and 128 threads, ceil(S / 32) of them (128 at 4096
// streams); dynamic shared memory a block 30,272 / 25,664 / 83,328
// bytes (the ring 16,448, a producer's copy buffer 4,608; mxu: + the
// band 18,432 and a window 11,520 a producer, 128-byte aligned);
// registers 128 (the cap of 4 blocks an SM; the vpu producer spills
// 340 bytes) / 155 / 241 (144 bytes of stack), the same for B1 and B2.
// At 16,384 streams vpu and lobe run in one wave (4 blocks an SM); mxu,
// whose shared memory allows 2 blocks an SM, in two.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mxu.cuh"
#include "pipeline_ring.cuh"
#include "pipeline_step.cuh"

namespace gnuais {

enum class Fir { kExact, kLobe, kMxu };

// Pointers and sizes of one launch; the layouts are the wrappers' in
// gnuais_tpu_torch/ops/fused.py.
struct PipelineArgs {
  const int16_t* x;        // [T, pitch] time-major or [S, pitch] row-major
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
  int row_major, pitch;    // the input's layout and its row stride
};

// Producer warps a consumer warp has, per FIR mode: enough that the
// chunks are filtered faster than the consumer's chain takes them.
template <Fir kFir>
constexpr int kProducers = kFir == Fir::kMxu ? kMxuProducers
                                             : (kFir == Fir::kLobe ? 2 : 3);

template <Fir kFir>
constexpr int kPipelineThreads = 32 * (1 + kProducers<kFir>);

// Blocks an SM must hold, so that 16,384 streams (512 blocks) run in one
// wave on 132 SMs: it caps the registers a thread at 65,536 / (4 x 128).
// The mxu mode's shared memory allows two blocks an SM only.
template <Fir kFir>
constexpr int kMinBlocks = kFir == Fir::kMxu ? 2 : 4;

template <Fir kFir>
constexpr size_t pipeline_shared_bytes() {
  return kFir == Fir::kMxu ? sizeof(MxuShared)
                           : sizeof(RingShared<kProducers<kFir>>);
}

// A stream's DPLL and HDLC carry and its frame book-keeping.
struct StreamRegs {
  DpllRegs d;
  HdlcRegs h;
  int32_t count, lost2, over, chunk_count;
};

// The deframer's carry (HDLC state and register) and zeroed counters;
// also the whole carry of the deframer kernel (hdlc.cu).
__device__ __forceinline__ void load_hdlc_carry(const PipelineArgs& a, int s,
                                                StreamRegs& r) {
  const int S = a.S;
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

__device__ __forceinline__ void load_carry(const PipelineArgs& a, int s,
                                           StreamRegs& r) {
  const int S = a.S;
  r.d = DpllRegs{a.dpll_in[s], a.dpll_in[S + s], a.dpll_in[2 * S + s]};
  load_hdlc_carry(a, s, r);
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
__device__ __forceinline__ void store_hdlc_carry(const PipelineArgs& a, int s,
                                                 const StreamRegs& r) {
  const int S = a.S;
  if constexpr (!kCandidates) a.count_raw[s] = r.count;
  a.lost2[s] = r.lost2;
  a.over[s] = r.over;
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

template <bool kCandidates>
__device__ __forceinline__ void store_carry(const PipelineArgs& a, int s,
                                            const StreamRegs& r) {
  const int S = a.S;
  a.dpll_out[s] = r.d.pll;
  a.dpll_out[S + s] = r.d.prev;
  a.dpll_out[2 * S + s] = r.d.lastbit;
  store_hdlc_carry<kCandidates>(a, s, r);
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

// The consumer warp: stream s's chain over the ring's chunks.  A lane
// past the last stream takes part in the barriers only.
template <bool kCandidates>
__device__ __forceinline__ void pipeline_consumer(const PipelineArgs a,
                                                  Ring& ring, int s, int nv,
                                                  int n_chunks) {
  const bool live = s < a.S;
  StreamRegs r;
  if (live) load_carry(a, s, r);
  ring_consume(ring, n_chunks, [&](int t0, const float* f) {
    if (!live) return;
    // each group's 4 values read one group ahead of its chain
    float next[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) next[k] = f[k * 32];
#pragma unroll 1
    for (int q = 0; q < kChunk / 4; ++q) {
      const int g = t0 / 4 + q;
      if (4 * g >= nv) break;
      float cur[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cur[k] = next[k];
      if (q + 1 < kChunk / 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) next[k] = f[(4 * q + 4 + k) * 32];
      }
      bool gval = false;
      int32_t gbit = 0, gpos = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * g + k;
        if (t < nv) sample_step(a, r, cur[k], t, gval, gbit, gpos);
      }
      slot_step<kCandidates>(a, s, g, gval, gbit, gpos, r);
    }
  });
  if (live) store_carry<kCandidates>(a, s, r);
}

// Producer warp p with the FIR kFir (vpu or lobe): the chunk's window in
// registers, its 32 outputs written into the stage.
template <Fir kFir>
__device__ __forceinline__ void pipeline_producer(RingShared<kProducers<kFir>>& sh,
                                                  const RingInput& in, int s0,
                                                  int n_chunks, int p,
                                                  const float* hist) {
  const int lane = threadIdx.x % 32;
  float v[kRawLen];
  ring_produce(sh.ring, sh.raw[p], in, s0, n_chunks, p, kProducers<kFir>,
               [&](int t0) {
                 raw_column(sh.raw[p], in.row_major, lane, t0, hist, v);
               },
               [&](float* stage) {
    // output k, sample t0 + k, filters samples t0 + k - 36 .. t0 + k - 1
    constexpr int o = kRawLead - kFirLen;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      stage[k * 32 + lane] = kFir == Fir::kLobe ? fir_lobe_at(v, o + k)
                                                : fir_exact_at(v, o + k);
  });
}

// The kernel of both entry points: block b serves streams 32b .. 32b + 31,
// warp 0 the chain, warps 1 .. P the FIR.  `a` by value: a reference to
// the kernel's parameter made the earlier one-thread-per-stream kernels
// ~8 % slower on an H100.
template <Fir kFir, bool kCandidates>
__global__ void __launch_bounds__(kPipelineThreads<kFir>, kMinBlocks<kFir>)
pipeline_kernel(const PipelineArgs a, bool vec) {
  unsigned char* smem = block_shared();
  auto& sh = *reinterpret_cast<RingShared<kProducers<kFir>>*>(smem);
  ring_init(sh.ring);
  if constexpr (kFir == Fir::kMxu)
    mxu_band_init(reinterpret_cast<MxuShared*>(smem)->band);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int s0 = blockIdx.x * kChunk;
  const int s = s0 + threadIdx.x % 32;
  // samples past n_valid freeze; every warp counts the same chunks
  const int nv = a.n_valid < a.T ? (a.n_valid > 0 ? a.n_valid : 0) : a.T;
  const int n_chunks = (nv + kChunk - 1) / kChunk;
  if (warp == 0) {
    pipeline_consumer<kCandidates>(a, sh.ring, s, nv, n_chunks);
    return;
  }
  const RingInput in{a.x, a.hist, a.S, a.T, a.pitch, a.row_major != 0, vec};
  const float* hist = s < a.S ? a.hist + (size_t)s * kFirLen : nullptr;
  if constexpr (kFir == Fir::kMxu) {
    mxu_produce(*reinterpret_cast<MxuShared*>(smem), in, s0, n_chunks,
                warp - 1, hist);
  } else {
    pipeline_producer<kFir>(sh, in, s0, n_chunks, warp - 1, hist);
  }
}

template <Fir kFir, bool kCandidates>
int launch_pipeline_mode(const PipelineArgs& a, cudaStream_t st) {
  constexpr int threads = kPipelineThreads<kFir>;
  constexpr size_t smem = pipeline_shared_bytes<kFir>();
  // above 48 KB a block's dynamic shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      pipeline_kernel<kFir, kCandidates>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.S + kChunk - 1) / kChunk;
  const bool vec = ring_vec_ok(a.x, a.pitch);
  pipeline_kernel<kFir, kCandidates><<<blocks, threads, smem, st>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launches pipeline_kernel<fir_mode, kCandidates> on `stream`
// (fir_mode 0 = exact, 1 = lobe, 2 = mxu) and returns cudaGetLastError(),
// so a refused launch, or an unknown mode, is reported to the caller.
template <bool kCandidates>
int launch_pipeline(const PipelineArgs& a, int fir_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fir_mode == 0) return launch_pipeline_mode<Fir::kExact, kCandidates>(a, st);
  if (fir_mode == 1) return launch_pipeline_mode<Fir::kLobe, kCandidates>(a, st);
  if (fir_mode == 2) return launch_pipeline_mode<Fir::kMxu, kCandidates>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnuais
