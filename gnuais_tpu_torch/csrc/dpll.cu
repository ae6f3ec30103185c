// DPLL clock recovery kernel: slicer, DPLL and NRZI over filtered float32.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_dpll_kernel`, called
// through `dpll_pallas_tiles` and `dpll_fused`: per sample, the sign of
// the filtered value steps the 16-bit phase accumulator; a wrap past
// 0xFFFF emits the NRZI-decoded bit.  Samples at index >= n_valid freeze
// the state and emit nothing.  Output: one code per sample, 2 + bit on an
// emission and 0 elsewhere (the TPU kernel's `2*valid + bit`), and the
// new DPLL state.
//
// What bounds it on an H100: each stream is one dependent chain of ~10
// integer ops per sample with no parallelism inside the stream, so the
// kernel is latency-bound per thread.  At 4096 streams the grid is 32
// blocks of 128 threads: 32 of the 132 SMs busy, as for the fused kernel
// (pipeline_compact.cu).  A block of 49,152 samples reads 805 MB of
// float32 and writes 201 MB of codes.
// Design: one thread per stream, the state in registers, time-major
// input [T, S] and output [T, S] so that a warp's 32 loads and stores at
// one time step are neighbouring; the loads do not depend on the chain,
// so the unrolled loop starts several of them ahead of the arithmetic.
// The codes are uint8.  The wrapper turns them into the [S, T] bool and
// int32 arrays of the plain version with one transpose copy of the
// codes (a read and a write of 201 MB) and two elementwise passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace {

using namespace gnuais;

__global__ void __launch_bounds__(128) dpll_kernel(
    const float* __restrict__ x,          // [T, S] filtered samples
    const int32_t* __restrict__ dpll_in,  // [3, S]: pll, prev, lastbit
    uint8_t* __restrict__ codes,          // [T, S]: 2 + bit on an emission, else 0
    int32_t* __restrict__ dpll_out,       // [3, S]
    int S, int T, int n_valid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  DpllRegs d{dpll_in[s], dpll_in[S + s], dpll_in[2 * S + s]};
  const int nv = n_valid < T ? n_valid : T;   // samples past n_valid freeze
#pragma unroll 8
  for (int t = 0; t < nv; ++t) {
    int32_t bit;
    const bool emit = dpll_step(d, x[(size_t)t * S + s], &bit);
    codes[(size_t)t * S + s] = emit ? static_cast<uint8_t>(2 + bit) : 0;
  }
  for (int t = nv; t < T; ++t) codes[(size_t)t * S + s] = 0;
  dpll_out[s] = d.pll;
  dpll_out[S + s] = d.prev;
  dpll_out[2 * S + s] = d.lastbit;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.
extern "C" int gnuais_dpll(const void* x, const void* dpll_in, void* codes,
                           void* dpll_out, int S, int T, int n_valid,
                           void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (S + kThreads - 1) / kThreads;
  dpll_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(dpll_in),
      static_cast<uint8_t*>(codes), static_cast<int32_t*>(dpll_out), S, T,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}
