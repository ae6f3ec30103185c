// Kernel B4: DPLL clock recovery, the slicer, DPLL and NRZI over filtered
// float32.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_dpll_kernel`, called
// through `dpll_pallas_tiles` and `dpll_fused`: per sample, the sign of
// the filtered value steps the 16-bit phase accumulator; a wrap past
// 0xFFFF emits the NRZI-decoded bit.  Samples at index >= n_valid freeze
// the state and emit nothing.  Output: one code per sample, 2 + bit on an
// emission and 0 elsewhere (the TPU kernel's `2*valid + bit`), time-major
// [T, S] uint8 as the deframer kernel (hdlc.cu) reads it, and the new
// DPLL state.
//
// What bounds it on an H100: each stream is one dependent chain of ~10
// integer operations a sample with no parallelism inside the stream (R1:
// 11 ns a step, 0.55 ms for 49,152 samples); a block of 4096 x 49,152
// samples reads 805 MB of float32 and writes 201 MB of codes (0.30 ms at
// 3.35 TB/s).
// Design: a ring in shared memory between a copy warp and a chain warp,
// one pair per 32 streams.  The copy warp copies chunks of 32 streams x 32
// samples of the row-major [S, pitch] input, read in place, with
// cp.async (16 bytes: 4 samples of one stream) into kStages stages, each
// stream's 32 samples a row padded to 36 floats, so that the chain warp's
// 16-byte reads of one row a lane hit distinct banks; it keeps kAhead
// chunks in flight past the one it has handed over.  The chain warp, one
// lane a stream, reads a chunk's 32 values into registers, releases the
// stage and runs dpll_step over them, storing a code a sample: a warp's
// 32 stores of one sample are one 32-byte piece of a row.  full/empty
// mbarriers per stage as in pipeline_ring.cuh.  Blocks of 64 threads,
// ceil(S / 32) of them, 36,992 bytes of dynamic shared memory each.

#include "pipeline_ring.cuh"

namespace {

using namespace gnuais;

constexpr int kStagesB4 = 8;
constexpr int kAhead = 6;     // chunks whose copies are in flight past the
                              // one handed over; kStagesB4 >= kAhead + 1
constexpr int kRow = 36;      // floats a stream's row in a stage

struct DpllShared {
  float stage[kStagesB4][32 * kRow];   // [stream][sample]
  uint64_t full[kStagesB4];
  uint64_t empty[kStagesB4];
};

struct DpllArgs {
  const float* x;          // [S, pitch] filtered samples
  const int32_t* dpll_in;  // [3, S]: pll, prev, lastbit
  uint8_t* codes;          // [T, S]: 2 + bit on an emission, else 0
  int32_t* dpll_out;       // [3, S]
  int S, T, n_valid, pitch;
  bool vec;                // 16-byte copies allowed (pointer and pitch aligned)
};

// Issues this lane's part of the copy of chunk k (samples 32k .. 32k + 31
// of streams s0 .. s0 + 31) into `stage`: 256 pieces of 4 samples, 8 a
// lane; cp.async where the piece lies inside the input and a.vec, sample
// by sample otherwise, zero outside the input.
__device__ __forceinline__ void chunk_fetch(float* stage, const DpllArgs& a,
                                            int s0, int k, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = lane + 32 * j;
    const int row = c / 8, part = c % 8;
    const int s = s0 + row;
    const int t = 32 * k + 4 * part;
    float* dst = stage + row * kRow + 4 * part;
    const float* src = a.x + (size_t)s * a.pitch + t;
    if (a.vec && s < a.S && t + 4 <= a.T) {
      copy16_async(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (s < a.S && t + e < a.T) ? src[e] : 0.0f;
    }
  }
  copy_commit();
}

// The copy warp: chunk k's copy is issued once its stage is free, and
// its stage handed over (each lane's arrival after its own copies have
// landed) once kAhead later chunks are issued, or at the end.
__device__ __forceinline__ void dpll_producer(DpllShared& sh, const DpllArgs& a,
                                              int s0, int n_chunks) {
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % kStagesB4;
    bar_wait(&sh.empty[st], ((k / kStagesB4) & 1) ^ 1);
    chunk_fetch(sh.stage[st], a, s0, k, lane);
    if (k >= kAhead) {
      copy_wait_pending<kAhead>();
      bar_arrive(&sh.full[(k - kAhead) % kStagesB4]);
    }
  }
  copy_wait();
  for (int k = n_chunks > kAhead ? n_chunks - kAhead : 0; k < n_chunks; ++k)
    bar_arrive(&sh.full[k % kStagesB4]);
}

// The chain warp: stream s's DPLL over the chunks, a code a sample.  A
// lane past the last stream takes part in the barriers only.
__device__ __forceinline__ void dpll_consumer(DpllShared& sh, const DpllArgs& a,
                                              int s, int nv, int n_chunks) {
  const int lane = threadIdx.x % 32;
  const bool live = s < a.S;
  DpllRegs d{0, 0, 0};
  if (live) d = DpllRegs{a.dpll_in[s], a.dpll_in[a.S + s], a.dpll_in[2 * a.S + s]};
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % kStagesB4;
    bar_wait(&sh.full[st], (k / kStagesB4) & 1);
    float v[kChunk];
    const float* row = sh.stage[st] + lane * kRow;
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(row + 4 * j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
    bar_arrive(&sh.empty[st]);
    if (!live) continue;
    if (kChunk * (k + 1) <= nv) {
      // a whole chunk of valid samples, without the per-sample guards
      // of the last chunk: they cost the chain about half its time
      uint8_t* out = a.codes + (size_t)(kChunk * k) * a.S + s;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        int32_t bit;
        const bool emit = dpll_step(d, v[j], &bit);
        out[(size_t)j * a.S] = emit ? static_cast<uint8_t>(2 + bit) : 0;
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = kChunk * k + j;
      if (t >= a.T) break;
      int32_t bit;
      const bool emit = t < nv && dpll_step(d, v[j], &bit);
      a.codes[(size_t)t * a.S + s] = emit ? static_cast<uint8_t>(2 + bit) : 0;
    }
  }
  if (!live) return;
  for (int t = kChunk * n_chunks; t < a.T; ++t) a.codes[(size_t)t * a.S + s] = 0;
  a.dpll_out[s] = d.pll;
  a.dpll_out[a.S + s] = d.prev;
  a.dpll_out[2 * a.S + s] = d.lastbit;
}

__global__ void __launch_bounds__(64) dpll_kernel(const DpllArgs a) {
  auto& sh = *reinterpret_cast<DpllShared*>(block_shared());
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesB4; ++i) {
      bar_init(&sh.full[i], 32);
      bar_init(&sh.empty[i], 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int s0 = blockIdx.x * 32;
  const int nv = a.n_valid < a.T ? (a.n_valid > 0 ? a.n_valid : 0) : a.T;
  const int n_chunks = (nv + kChunk - 1) / kChunk;
  if (threadIdx.x / 32 == 0)
    dpll_consumer(sh, a, s0 + threadIdx.x % 32, nv, n_chunks);
  else
    dpll_producer(sh, a, s0, n_chunks);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  x: row-major [S, pitch]
// float32; codes: [T, S] uint8.
extern "C" int gnuais_dpll(const void* x, const void* dpll_in, void* codes,
                           void* dpll_out, int S, int T, int n_valid,
                           int pitch, void* stream) {
  constexpr size_t smem = sizeof(DpllShared);
  const cudaError_t err = cudaFuncSetAttribute(
      dpll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const DpllArgs a{static_cast<const float*>(x),
                   static_cast<const int32_t*>(dpll_in),
                   static_cast<uint8_t*>(codes), static_cast<int32_t*>(dpll_out),
                   S, T, n_valid, pitch,
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && pitch % 4 == 0};
  const int blocks = (S + 31) / 32;
  dpll_kernel<<<blocks, 64, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
