// The ring of filtered chunks between the FIR producer warps and the
// chain consumer warp of kernels B1 and B2 (pipeline_kernel.cuh), also
// run by the mxu probe (fir_probe.cu).
//
// A block serves 32 streams, one per lane.  Time is cut into chunks of
// kChunk = 32 samples; chunk k holds samples 32k .. 32k + 31.  Producer
// warp p of P takes chunks p, p + P, p + 2P, ...: it copies the chunk's
// raw int16 window (the 40 samples before it and its own 32) into its
// own buffer in shared memory, asynchronously (cp.async) where the
// input's alignment allows, reads its stream's column out of it, then
// filters the chunk into stage k % kStages of the ring:
// stage[sample][stream], 32 x 32 floats, which the consumer reads
// without bank conflicts.  The next chunk's copy is issued before the
// FIR runs, so its latency hides behind the filtering.
//
// Each stage has two mbarriers: "full" (32 arrivals: the producing warp's
// lanes, after writing) and "empty" (32 arrivals: the consumer's lanes,
// after reading the chunk into registers).  Use n of stage st (chunk
// st + n * kStages) waits for full phase n and empty phase n - 1, by
// parity.  A parity wait tells two phases apart only, so no producer
// may come two uses ahead on a stage: producer p fills chunk k only
// after chunk k - P, which needed chunk k - P - kStages released, and
// with kStages >= P + 1 that covers chunk k - 2 * kStages.  Every warp
// counts the chunks from the scalar n_valid, so nobody waits on a
// stage that is never filled or freed (n_valid = 0 runs no chunk).
//
// The input comes in either layout, the one the caller holds:
// time-major [T, pitch] (rows of samples, stream s at column s; the
// pretiled path) or row-major [S, pitch] (stream s's samples in row s;
// the JAX package's own layout).  A 16-byte copy needs the pointer and
// the pitch aligned; otherwise, and at every edge (t < 0, t >= T,
// s >= S), the samples are copied one by one and the gaps zero-filled.
//
// Kernel B2's prefiltered mode feeds the ring with float32 samples that
// were filtered before the call: its producers only copy (f32_fetch
// below).
//
// A host build (gnuais_tpu_torch/hostbuild) compiles this file as C++
// with GNUAIS_HOST_BUILD defined: a barrier becomes an atomic word, a
// copy a plain one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "pipeline_step.cuh"

namespace gnuais {

constexpr int kChunk = 32;        // samples a chunk, and streams a block
constexpr int kRawLead = 40;      // raw samples kept before a chunk
constexpr int kRawLen = kRawLead + kChunk;   // 72: 9 copies of 16 bytes
constexpr int kStages = 4;        // ring stages; >= producers + 1

// The dynamic shared memory of the block.
__device__ __forceinline__ unsigned char* block_shared() {
#ifdef GNUAIS_HOST_BUILD
  return gnuais_host::shared();
#else
  extern __shared__ __align__(128) unsigned char gnuais_smem[];
  return gnuais_smem;
#endif
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
#if defined(__CUDA_ARCH__)
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(addr), "r"(count)
               : "memory");
#elif defined(GNUAIS_HOST_BUILD)
  gnuais_host::bar_init(bar, count);
#endif
}

// Makes the initialised barriers visible to the other threads, before the
// block synchronises.
__device__ __forceinline__ void bar_init_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(addr)
               : "memory");
#elif defined(GNUAIS_HOST_BUILD)
  gnuais_host::bar_arrive(bar);
#endif
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
#if defined(__CUDA_ARCH__)
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
#elif defined(GNUAIS_HOST_BUILD)
  gnuais_host::bar_wait(bar, parity);
#endif
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(addr), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;" ::: "memory");
#endif
}

// Waits until at most kPending of this thread's committed copy groups
// are still in flight (the host build's copies are done at once).
template <int kPending>
__device__ __forceinline__ void copy_wait_pending() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
#endif
}

// ---- the ring -------------------------------------------------------------

struct Ring {
  float stage[kStages][kChunk * 32];   // [sample][stream]
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// One producer's raw window: 72 rows of 32 streams (time-major input) or
// 32 rows of 72 samples (row-major input), 4,608 bytes either way.
struct alignas(16) RawWindow {
  int16_t v[kRawLen * 32];
};

// The block's shared memory with P producer warps (the mxu mode adds its
// own after it, fir_mxu.cuh MxuShared).
template <int P>
struct RingShared {
  Ring ring;
  RawWindow raw[P];
};

// Where a block's producers read their samples.
struct RingInput {
  const int16_t* x;     // [T, pitch] time-major or [S, pitch] row-major
  const float* hist;    // [S, 36]: the samples before t = 0
  int S, T, pitch;
  bool row_major;
  bool vec;             // 16-byte copies allowed (pointer and pitch aligned)
};

// 16-byte copies need x 16-byte aligned and a pitch of whole 8 samples
// (time-major rows, row-major streams); the window's first sample,
// 40 before a chunk, is on an 8-sample boundary already.
inline bool ring_vec_ok(const void* x, int pitch) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && pitch % 8 == 0;
}

__device__ __forceinline__ void ring_init(Ring& ring) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&ring.full[i], 32);
      bar_init(&ring.empty[i], 32);
    }
    bar_init_fence();
  }
}

// Issues this lane's part of the copy of chunk t0's raw window (samples
// t0 - 40 .. t0 + 31 of streams s0 .. s0 + 31) into `raw`: 288 pieces of
// 8 samples, 9 a lane.  A piece wholly inside the input goes as one
// 16-byte asynchronous copy when in.vec; any other is copied sample by
// sample, zero outside the input.
__device__ __forceinline__ void raw_fetch(RawWindow& raw, const RingInput& in,
                                          int s0, int t0, int lane) {
#pragma unroll
  for (int j = 0; j < kRawLen * 32 / 8 / 32; ++j) {
    const int c = lane + 32 * j;
    int t, s;
    int16_t* dst;
    if (in.row_major) {        // piece: 8 samples of one stream
      const int row = c / (kRawLen / 8), part = c % (kRawLen / 8);
      t = t0 - kRawLead + 8 * part;
      s = s0 + row;
      dst = raw.v + row * kRawLen + 8 * part;
    } else {                   // piece: one sample of 8 streams
      const int row = c / 4, part = c % 4;
      t = t0 - kRawLead + row;
      s = s0 + 8 * part;
      dst = raw.v + row * 32 + 8 * part;
    }
    // element e of the piece is at + e either way
    const size_t at = in.row_major ? (size_t)s * in.pitch + t
                                   : (size_t)t * in.pitch + s;
    const bool whole = in.row_major
        ? (s < in.S && t >= 0 && t + 8 <= in.T)
        : (t >= 0 && t < in.T && s + 8 <= in.S);
    if (whole && in.vec) {
      copy16_async(dst, in.x + at);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int te = in.row_major ? t + e : t;
        const int se = in.row_major ? s : s + e;
        dst[e] = (te >= 0 && te < in.T && se < in.S) ? in.x[at + e] : int16_t(0);
      }
    }
  }
  copy_commit();
}

// This lane's stream's window of chunk t0 as floats: v[r] is sample
// t0 - 40 + r, from the carried history where that is negative (hist:
// the stream's 36 floats, nullptr for a lane past the last stream), zero
// past T.
__device__ __forceinline__ void raw_column(const RawWindow& raw, bool row_major,
                                           int lane, int t0, const float* hist,
                                           float (&v)[kRawLen]) {
  if (row_major) {
#pragma unroll
    for (int j = 0; j < kRawLen / 8; ++j) {
      // one 16-byte read: lanes 0..7 of a quarter warp hit distinct banks
      const int4 q = *reinterpret_cast<const int4*>(raw.v + lane * kRawLen + 8 * j);
      const int32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * j + 2 * e] = static_cast<float>(static_cast<int16_t>(w[e] & 0xFFFF));
        v[8 * j + 2 * e + 1] = static_cast<float>(static_cast<int16_t>(w[e] >> 16));
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRawLen; ++r) v[r] = static_cast<float>(raw.v[r * 32 + lane]);
  }
  if (t0 < kRawLead) {   // chunks 0 and 1 reach into the history
#pragma unroll
    for (int r = 0; r < kRawLen; ++r) {
      const int t = t0 - kRawLead + r;
      if (t < 0) v[r] = (hist != nullptr && t >= -kFirLen) ? hist[kFirLen + t] : 0.0f;
    }
  }
}

// The loop of producer warp p of n_producers over chunks p, p + n, ...:
// per chunk, `fetch(t0)` issues the copy of chunk t0's input into the
// producer's buffer, `load(t0)` reads it out (the copy waited for and
// synchronised over the warp), then the next chunk's copy is issued, and
// `store(stage)` writes the chunk's 32 x 32 values into its ring stage
// once the stage is free.
template <typename Fetch, typename Load, typename Store>
__device__ __forceinline__ void ring_produce_with(Ring& ring, int n_chunks,
                                                  int p, int n_producers,
                                                  Fetch&& fetch, Load&& load,
                                                  Store&& store) {
  if (p < n_chunks) fetch(p * kChunk);
  for (int k = p; k < n_chunks; k += n_producers) {
    copy_wait();
    __syncwarp();
    load(k * kChunk);
    __syncwarp();          // every lane is done with the buffer
    if (k + n_producers < n_chunks) fetch((k + n_producers) * kChunk);
    const int st = k % kStages;
    bar_wait(&ring.empty[st], ((k / kStages) & 1) ^ 1);
    store(ring.stage[st]);
    bar_arrive(&ring.full[st]);
  }
}

// The same over the raw int16 windows of the block's streams s0 ..
// s0 + 31 in `raw`: `load(t0)` reads the window out of it.
template <typename Load, typename Store>
__device__ __forceinline__ void ring_produce(Ring& ring, RawWindow& raw,
                                             const RingInput& in, int s0,
                                             int n_chunks, int p,
                                             int n_producers, Load&& load,
                                             Store&& store) {
  const int lane = threadIdx.x % 32;
  ring_produce_with(ring, n_chunks, p, n_producers,
                    [&](int t0) { raw_fetch(raw, in, s0, t0, lane); },
                    load, store);
}

// ---- prefiltered input (kernel B2's prefiltered mode) --------------------
//
// The producers filter nothing: each copies a chunk of float32 samples
// (32 samples of 32 streams, 4,096 bytes) into its buffer, reads its
// stream's 32 values out of it and writes them into the stage.  The
// buffer is the RawWindow's 4,608 bytes: 32 rows of 32 streams
// (time-major input) or 32 rows of 32 samples 36 floats apart (row-major
// input), so that the lanes' 16-byte reads of their own rows hit
// distinct banks.

constexpr int kF32Ld = 36;
static_assert(sizeof(RawWindow) == kChunk * kF32Ld * sizeof(float),
              "the float32 chunk fills the raw window");

// Where a block's producers read prefiltered samples.
struct F32Input {
  const float* x;       // [T, pitch] time-major or [S, pitch] row-major
  int S, T, pitch;
  bool row_major;
  bool vec;             // 16-byte copies allowed (pointer and pitch aligned)
};

// 16-byte copies need x 16-byte aligned and a pitch of whole 4 floats.
inline bool ring_vec_ok_f32(const void* x, int pitch) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && pitch % 4 == 0;
}

// Issues this lane's part of the copy of chunk t0 (samples t0 .. t0 + 31
// of streams s0 .. s0 + 31) into `raw`: 256 pieces of 4 floats, 8 a
// lane, each one 16-byte asynchronous copy where it lies wholly inside
// the input and in.vec, else copied float by float, zero outside.
__device__ __forceinline__ void f32_fetch(RawWindow& raw, const F32Input& in,
                                          int s0, int t0, int lane) {
  float* buf = reinterpret_cast<float*>(raw.v);
#pragma unroll
  for (int j = 0; j < kChunk * kChunk / 4 / 32; ++j) {
    const int c = lane + 32 * j;
    const int row = c / 8, part = c % 8;
    // row-major: row a stream, the piece 4 of its samples; time-major:
    // row a sample, the piece 4 of its streams
    const int t = in.row_major ? t0 + 4 * part : t0 + row;
    const int s = in.row_major ? s0 + row : s0 + 4 * part;
    float* dst = buf + row * (in.row_major ? kF32Ld : kChunk) + 4 * part;
    const size_t at = in.row_major ? (size_t)s * in.pitch + t
                                   : (size_t)t * in.pitch + s;
    const bool whole = in.row_major ? (s < in.S && t + 4 <= in.T)
                                    : (t < in.T && s + 4 <= in.S);
    if (whole && in.vec) {
      copy16_async(dst, in.x + at);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int te = in.row_major ? t + e : t;
        const int se = in.row_major ? s : s + e;
        dst[e] = (te < in.T && se < in.S) ? in.x[at + e] : 0.0f;
      }
    }
  }
  copy_commit();
}

// This lane's stream's 32 values of the chunk in `raw`.
__device__ __forceinline__ void f32_column(const RawWindow& raw,
                                           bool row_major, int lane,
                                           float (&v)[kChunk]) {
  const float* buf = reinterpret_cast<const float*>(raw.v);
  if (row_major) {
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(buf + lane * kF32Ld + 4 * j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) v[k] = buf[k * kChunk + lane];
  }
}

// The consumer warp's loop over chunks 0 .. n_chunks - 1: once a chunk's
// stage is full, consume(t0, f) reads this lane's stream's 32 filtered
// values (sample t0 + k at f[k * 32]), and the stage is released.
template <typename Consume>
__device__ __forceinline__ void ring_consume(Ring& ring, int n_chunks,
                                             Consume&& consume) {
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % kStages;
    bar_wait(&ring.full[st], (k / kStages) & 1);
    consume(k * kChunk, static_cast<const float*>(ring.stage[st] + lane));
    bar_arrive(&ring.empty[st]);
  }
}

}  // namespace gnuais
