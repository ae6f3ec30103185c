// Kernel B3: exact FIR, DPLL with NRZI, 4-sample bit slots.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_frontend_kernel`,
// called through `frontend_fused`: raw int16 samples -> 36-tap FIR (one-
// sample delay, carried history) -> slicer, DPLL and NRZI -> each aligned
// 4-sample group reduced to one code, `valid<<3 | bit<<2 | offset` (at
// most one emission per group).  The filtered samples and the per-sample
// bits never reach device memory.  Samples at index >= n_valid freeze the
// DPLL and emit nothing; a group that straddles n_valid keeps only its
// valid samples, and the groups past it are 0.  The HDLC deframer is not
// in this kernel: the deframer kernel (hdlc.cu) reads its codes as they
// are written.
//
// What bounds it on an H100: the same per-stream chain as kernels B1/B2
// (pipeline_kernel.cuh) without the deframer, ~10 dependent integer
// operations of DPLL a sample (R1: 11 ns a step, 0.55 ms for 49,152
// samples); the FIR's 71 float operations a sample and the loads do not
// depend on it.  A block of 4096 x 49,152 samples reads 403 MB of int16
// and writes 50 MB of codes.
// Design: the body of B1/B2 with another consumer.  Per 32 streams, P = 3
// producer warps (pipeline_producer<Fir::kExact>) copy each 32-sample
// chunk's raw window of the row-major [S, pitch] block, read in place,
// and filter it into a ring in shared memory (pipeline_ring.cuh); the
// consumer warp, one lane a stream, runs only dpll_step and the group
// reduce over the ring's chunks and writes the codes time-major,
// [T/4, S], a warp's 32 bytes of one group side by side, as the
// deframer reads them.  Blocks of 128 threads, ceil(S / 32) of them,
// 30,272 bytes of dynamic shared memory each.

#include "pipeline_kernel.cuh"

namespace {

using namespace gnuais;

constexpr Fir kFir = Fir::kExact;

// The consumer warp: stream s's DPLL over the ring's chunks, one code a
// group into codes[g * S + s].  A lane past the last stream takes part in
// the barriers only.
__device__ __forceinline__ void frontend_consumer(const PipelineArgs& a,
                                                  uint8_t* codes, Ring& ring,
                                                  int s, int nv, int n_chunks) {
  const bool live = s < a.S;
  DpllRegs d{0, 0, 0};
  if (live) d = DpllRegs{a.dpll_in[s], a.dpll_in[a.S + s], a.dpll_in[2 * a.S + s]};
  ring_consume(ring, n_chunks, [&](int t0, const float* f) {
    if (!live) return;
    float next[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) next[k] = f[k * 32];
    if (t0 + kChunk <= nv) {
      // a whole chunk of valid samples, without the per-sample guards
      // of the last chunk
#pragma unroll 1
      for (int q = 0; q < kChunk / 4; ++q) {
        float cur[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cur[k] = next[k];
        if (q + 1 < kChunk / 4) {
#pragma unroll
          for (int k = 0; k < 4; ++k) next[k] = f[(4 * q + 4 + k) * 32];
        }
        uint32_t code = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int32_t bit;
          const bool emit = dpll_step(d, cur[k], &bit);
          code |= emit ? 8u | (static_cast<uint32_t>(bit) << 2) |
                             static_cast<uint32_t>(k)
                       : 0u;
        }
        codes[(size_t)(t0 / 4 + q) * a.S + s] = static_cast<uint8_t>(code);
      }
      return;
    }
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
      uint32_t code = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int32_t bit;
        if (4 * g + k < nv && dpll_step(d, cur[k], &bit))
          code |= 8u | (static_cast<uint32_t>(bit) << 2) | static_cast<uint32_t>(k);
      }
      codes[(size_t)g * a.S + s] = static_cast<uint8_t>(code);
    }
  });
  if (!live) return;
  for (int g = (nv + 3) / 4; g < a.T / 4; ++g) codes[(size_t)g * a.S + s] = 0;
  a.dpll_out[s] = d.pll;
  a.dpll_out[a.S + s] = d.prev;
  a.dpll_out[2 * a.S + s] = d.lastbit;
}

__global__ void __launch_bounds__(kPipelineThreads<kFir>, kMinBlocks<kFir>)
frontend_kernel(const PipelineArgs a, uint8_t* codes, bool vec) {
  auto& sh = *reinterpret_cast<RingShared<kProducers<kFir>>*>(block_shared());
  ring_init(sh.ring);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int s0 = blockIdx.x * kChunk;
  const int s = s0 + threadIdx.x % 32;
  const int nv = a.n_valid < a.T ? (a.n_valid > 0 ? a.n_valid : 0) : a.T;
  const int n_chunks = (nv + kChunk - 1) / kChunk;
  if (warp == 0) {
    frontend_consumer(a, codes, sh.ring, s, nv, n_chunks);
    return;
  }
  const RingInput in{a.x, a.hist, a.S, a.T, a.pitch, true, vec};
  const float* hist = s < a.S ? a.hist + (size_t)s * kFirLen : nullptr;
  pipeline_producer<kFir>(sh, in, s0, n_chunks, warp - 1, hist);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  x: row-major [S, pitch]
// int16, T % 4 == 0; codes: [T/4, S] uint8.
extern "C" int gnuais_frontend(const void* x, const void* hist,
                               const void* dpll_in, void* codes,
                               void* dpll_out, int S, int T, int n_valid,
                               int pitch, void* stream) {
  constexpr size_t smem = gnuais::pipeline_shared_bytes<kFir>();
  const cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gnuais::PipelineArgs a{
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, static_cast<int32_t*>(dpll_out),
      nullptr, nullptr, S, T, n_valid, 0, 0, 0, 0, 1, pitch};
  const int blocks = (S + gnuais::kChunk - 1) / gnuais::kChunk;
  frontend_kernel<<<blocks, gnuais::kPipelineThreads<kFir>, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint8_t*>(codes), gnuais::ring_vec_ok(x, pitch));
  return static_cast<int>(cudaGetLastError());
}
