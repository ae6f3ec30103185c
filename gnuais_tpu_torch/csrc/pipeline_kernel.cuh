// The fused decode kernel shared by kernels B1 (pipeline_compact.cu) and
// B2 (pipeline_fused.cu).
//
// Replaces the body of the TPU kernel gnuais_tpu/ops/fused.py
// `_pipeline_kernel`, which serves both of its wrappers through
// `compact_slots`: raw int16 samples -> 36-tap FIR (one-sample delay,
// carried history) -> DPLL slicer + NRZI -> 4-sample bit slots -> HDLC
// deframer -> completed frames, plus the new DPLL and HDLC carry.
//
// Compile-time choices:
// - the FIR: Fir::kExact (fir_mode "vpu", the exact chain's rounding),
//   Fir::kLobe (fir_mode "lobe", taps 10..25 in symmetric pairs),
//   Fir::kMxu (fir_mode "mxu", fused.py:735-747, 767-768, 902-903: a
//   banded matrix product per 32-sample chunk on the tensor cores,
//   fir_mxu.cuh) or Fir::kNone (B2's prefiltered mode, with_fir=False at
//   fused.py:645, 709, 729-731: float32 samples filtered before the call,
//   which the producers only copy, pipeline_ring.cuh f32_fetch);
// - the slots of a completed frame: dense (B1, at the stream's running
//   count in F slots) or candidates (B2, at slot c*2 + n of its 64-slot
//   chunk c, n the completions the chunk held before it, which
//   demod.compact_candidates then compacts);
// - when a frame is written: once after the 32-sample chunk that holds
//   it, as the JAX kernel's landing="body" (fused.py:661-671, 824-866;
//   JAX's default for B2, forced for B1 at :691, :1311): a chunk is 8 bit
//   slots, completions are >= ~47 slots apart and the register, data
//   start and state stay as they were from a stop flag to the next
//   register append >= ~27 slots later, so the consumer latches the one
//   emission (slot_latch) and lands it from the registers at the chunk's
//   end (land_frame): the frames of a landing at each emission slot
//   (JAX's landing="slot", which the deframer kernel hdlc.cu keeps,
//   slot_step), bitwise, and 9-17 % faster on an H100 (PERF.md);
// - kStrip, the JAX kernel's strip= bisection flags (pipeline_strip.cu,
//   an instrument: 0 for every decode path).
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
//   sample_step per sample, slot_latch per 4-sample group, land_frame
//   per 32-sample chunk), its state in registers, reading each chunk's
//   32 filtered values from its ring stage;
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
// 344 bytes) / 155 / 241 (144 bytes of stack), the same for B1 and B2.
// B2 prefiltered: P = 1 copy warp, 64 threads, 21,056 bytes (the ring
// and one raw window, which holds the float32 chunk), 106 registers.
// At 16,384 streams vpu and lobe run in one wave (4 blocks an SM); mxu,
// whose shared memory allows 2 blocks an SM, in two.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mxu.cuh"
#include "pipeline_ring.cuh"
#include "pipeline_step.cuh"

namespace gnuais {

enum class Fir { kExact, kLobe, kMxu, kNone };

// The JAX kernel's strip= flags (fused.py:733, 813-816, 833-837,
// 842-843, 856, 966), bits of kStrip; pipeline_strip.cu says what each
// leaves out of this kernel.
constexpr int kStripFir = 1;
constexpr int kStripHdlc = 2;
constexpr int kStripBook = 4;
constexpr int kStripShift = 8;
constexpr int kStripSnap = 16;
constexpr int kStripFlush = 32;

// Pointers and sizes of one launch; the layouts are the wrappers' in
// gnuais_tpu_torch/ops/fused.py.
struct PipelineArgs {
  const int16_t* x;        // [T, pitch] time-major or [S, pitch] row-major
                           // (float32 samples for Fir::kNone)
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
// chunks are filtered (or, prefiltered, copied) faster than the
// consumer's chain takes them.  One copy warp: with 1, 2 and 3 the
// prefiltered kernel ran within 0.3 % of each other on an H100
// (PERF.md).
constexpr int kCopyProducers = 1;

template <Fir kFir>
constexpr int kProducers = kFir == Fir::kMxu ? kMxuProducers
                         : kFir == Fir::kNone ? kCopyProducers
                         : (kFir == Fir::kLobe ? 2 : 3);

// Whether the producers run the tensor-core FIR (strip "fir" drops it).
template <Fir kFir, int kStrip>
constexpr bool kTensorFir = kFir == Fir::kMxu && !(kStrip & kStripFir);

template <Fir kFir>
constexpr int kPipelineThreads = 32 * (1 + kProducers<kFir>);

// Blocks an SM must hold, so that 16,384 streams (512 blocks) run in one
// wave on 132 SMs: it caps the registers a thread at 65,536 / (4 x 128).
// The mxu mode's shared memory allows two blocks an SM only.
template <Fir kFir>
constexpr int kMinBlocks = kFir == Fir::kMxu ? 2 : 4;

template <Fir kFir, int kStrip = 0>
constexpr size_t pipeline_shared_bytes() {
  return kTensorFir<kFir, kStrip> ? sizeof(MxuShared)
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

// A frame completed in 64-slot chunk c (flen payload bits, data start
// `start`, stop flag at `end`) written from the register as it stands.
template <bool kCandidates, int kStrip = 0>
__device__ __forceinline__ void land_frame(const PipelineArgs& a, int s, int c,
                                           int32_t flen, int32_t start,
                                           int32_t end, StreamRegs& r) {
  if (r.chunk_count < kMiniSlots) {
    // dense: the running count, while it fits the F slots;
    // candidates: the chunk's own slot, always inside K
    const int slot = kCandidates ? c * kMiniSlots + r.chunk_count : r.count;
    if (!(kStrip & kStripFlush) && slot < a.slots) {
      const size_t at = (size_t)s * a.slots + slot;
      if constexpr (!(kStrip & kStripSnap)) {
        int32_t* dst = a.words + at * kRegWords;
#pragma unroll
        for (int w = 0; w < kRegWords; ++w) dst[w] = static_cast<int32_t>(r.h.reg[w]);
        const size_t plane = (size_t)a.S * a.slots;
        a.fields[at] = flen;
        a.fields[plane + at] = start;
        a.fields[2 * plane + at] = end;
      }
      if constexpr (kCandidates) a.cand_valid[at] = 1;
    }
    ++r.count;
  } else if constexpr (!(kStrip & kStripBook)) {
    ++r.over;
  }
  ++r.chunk_count;
}

// One valid bit slot through the deframer, and a wrong-size stop flag
// counted in lost2.
template <int kStrip>
__device__ __forceinline__ SlotEvent deframe(const PipelineArgs& a,
                                             StreamRegs& r, int32_t gbit,
                                             int32_t gpos) {
  const SlotEvent ev = hdlc_step<!(kStrip & kStripShift)>(r.h, gbit, gpos);
  if constexpr (!(kStrip & kStripBook))
    if (ev.bad && gpos >= a.lost2_lo && gpos < a.lost2_hi) ++r.lost2;
  return ev;
}

// Group g's bit slot (gval: a bit was emitted, gbit at sample gpos)
// through the deframer, and a completed frame landed at once in its
// slot: the deframer kernel's landing (hdlc.cu), one slot at a time.
template <bool kCandidates>
__device__ __forceinline__ void slot_step(const PipelineArgs& a, int s,
                                          int g, bool gval, int32_t gbit,
                                          int32_t gpos, StreamRegs& r) {
  if (g % kHdlcChunk == 0) r.chunk_count = 0;
  if (!gval) return;
  const SlotEvent ev = deframe<0>(a, r, gbit, gpos);
  if (ev.emit)
    land_frame<kCandidates>(a, s, g / kHdlcChunk, ev.flen, ev.start, gpos, r);
}

// The latch of B1's and B2's landing: the one completion a 32-sample
// chunk can hold, landed after the chunk (land_frame).
struct BodyLatch {
  bool emit;
  int32_t flen, start, end;
};

template <int kStrip>
__device__ __forceinline__ void slot_latch(const PipelineArgs& a, int g,
                                           bool gval, int32_t gbit,
                                           int32_t gpos, StreamRegs& r,
                                           BodyLatch& lt) {
  if (g % kHdlcChunk == 0) r.chunk_count = 0;
  if (!gval) return;
  const SlotEvent ev = deframe<kStrip>(a, r, gbit, gpos);
  if (ev.emit) lt = BodyLatch{true, ev.flen, ev.start, gpos};
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
template <bool kCandidates, int kStrip = 0>
__device__ __forceinline__ void pipeline_consumer(const PipelineArgs a,
                                                  Ring& ring, int s, int nv,
                                                  int n_chunks) {
  const bool live = s < a.S;
  StreamRegs r;
  if (live) load_carry(a, s, r);
  ring_consume(ring, n_chunks, [&](int t0, const float* f) {
    if (!live) return;
    BodyLatch lt{false, 0, 0, 0};
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
      // strip "hdlc": no slot section at all
      if constexpr (!(kStrip & kStripHdlc))
        slot_latch<kStrip>(a, g, gval, gbit, gpos, r, lt);
    }
    if (lt.emit)
      land_frame<kCandidates, kStrip>(a, s, t0 / (4 * kHdlcChunk), lt.flen,
                                      lt.start, lt.end, r);
  });
  if (live) store_carry<kCandidates>(a, s, r);
}

// Producer warp p with the FIR kFir (vpu or lobe; with strip "fir" none,
// the raw samples cast): the chunk's window in registers, its 32 outputs
// written into the stage.
template <Fir kFir, int kStrip = 0>
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
      stage[k * 32 + lane] = (kStrip & kStripFir) ? v[kRawLead + k]
                           : kFir == Fir::kLobe ? fir_lobe_at(v, o + k)
                                                : fir_exact_at(v, o + k);
  });
}

// Producer warp p of B2's prefiltered mode: chunk t0's 32 values of the
// lane's stream copied into the stage.
template <int P>
__device__ __forceinline__ void copy_producer(RingShared<P>& sh,
                                              const F32Input& in, int s0,
                                              int n_chunks, int p) {
  const int lane = threadIdx.x % 32;
  float v[kChunk];
  ring_produce_with(sh.ring, n_chunks, p, P,
                    [&](int t0) { f32_fetch(sh.raw[p], in, s0, t0, lane); },
                    [&](int) { f32_column(sh.raw[p], in.row_major, lane, v); },
                    [&](float* stage) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) stage[k * 32 + lane] = v[k];
  });
}

// The kernel of both entry points: block b serves streams 32b .. 32b + 31,
// warp 0 the chain, warps 1 .. P the FIR.  `a` by value: a reference to
// the kernel's parameter made the earlier one-thread-per-stream kernels
// ~8 % slower on an H100.
template <Fir kFir, bool kCandidates, int kStrip = 0>
__global__ void __launch_bounds__(kPipelineThreads<kFir>, kMinBlocks<kFir>)
pipeline_kernel(const PipelineArgs a, bool vec) {
  unsigned char* smem = block_shared();
  auto& sh = *reinterpret_cast<RingShared<kProducers<kFir>>*>(smem);
  ring_init(sh.ring);
  if constexpr (kTensorFir<kFir, kStrip>)
    mxu_band_init(reinterpret_cast<MxuShared*>(smem)->band);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int s0 = blockIdx.x * kChunk;
  const int s = s0 + threadIdx.x % 32;
  // samples past n_valid freeze; every warp counts the same chunks
  const int nv = a.n_valid < a.T ? (a.n_valid > 0 ? a.n_valid : 0) : a.T;
  const int n_chunks = (nv + kChunk - 1) / kChunk;
  if (warp == 0) {
    pipeline_consumer<kCandidates, kStrip>(a, sh.ring, s, nv, n_chunks);
    return;
  }
  if constexpr (kFir == Fir::kNone) {
    const F32Input in{reinterpret_cast<const float*>(a.x), a.S, a.T, a.pitch,
                      a.row_major != 0, vec};
    copy_producer(sh, in, s0, n_chunks, warp - 1);
  } else {
    const RingInput in{a.x, a.hist, a.S, a.T, a.pitch, a.row_major != 0, vec};
    const float* hist = s < a.S ? a.hist + (size_t)s * kFirLen : nullptr;
    if constexpr (kTensorFir<kFir, kStrip>) {
      mxu_produce(*reinterpret_cast<MxuShared*>(smem), in, s0, n_chunks,
                  warp - 1, hist);
    } else {
      pipeline_producer<kFir, kStrip>(sh, in, s0, n_chunks, warp - 1, hist);
    }
  }
}

template <Fir kFir, bool kCandidates, int kStrip = 0>
int launch_pipeline_mode(const PipelineArgs& a, cudaStream_t st) {
  constexpr int threads = kPipelineThreads<kFir>;
  constexpr size_t smem = pipeline_shared_bytes<kFir, kStrip>();
  // above 48 KB a block's dynamic shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      pipeline_kernel<kFir, kCandidates, kStrip>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.S + kChunk - 1) / kChunk;
  const bool vec = kFir == Fir::kNone ? ring_vec_ok_f32(a.x, a.pitch)
                                      : ring_vec_ok(a.x, a.pitch);
  pipeline_kernel<kFir, kCandidates, kStrip><<<blocks, threads, smem, st>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launches B2 (pipeline_kernel<fir_mode, true, kStrip>, the strip flags
// kStrip) on `stream` (fir_mode 0 = exact, 1 = lobe, 2 = mxu or 3 =
// prefiltered) and returns cudaGetLastError(), so a refused launch, or an
// unknown mode, is reported to the caller.  A template, as every launch
// helper here: a source that includes this header compiles only the
// kernels it launches.
template <int kStrip>
int launch_candidates(const PipelineArgs& a, int fir_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fir_mode == 0) return launch_pipeline_mode<Fir::kExact, true, kStrip>(a, st);
  if (fir_mode == 1) return launch_pipeline_mode<Fir::kLobe, true, kStrip>(a, st);
  if (fir_mode == 2) return launch_pipeline_mode<Fir::kMxu, true, kStrip>(a, st);
  if (fir_mode == 3) return launch_pipeline_mode<Fir::kNone, true, kStrip>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnuais
