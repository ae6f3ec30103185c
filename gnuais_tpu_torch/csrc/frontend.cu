// Fused front-end kernel: exact FIR, DPLL with NRZI, 4-sample bit slots.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_frontend_kernel`,
// called through `frontend_fused`: raw int16 samples -> 36-tap FIR (one-
// sample delay, carried history) -> slicer, DPLL and NRZI -> each aligned
// 4-sample group reduced to one code, `valid<<3 | bit<<2 | offset` (at
// most one emission per group).  The filtered samples and the per-sample
// bits never reach device memory.  Samples at index >= n_valid freeze the
// DPLL and emit nothing; a group that straddles n_valid keeps only its
// valid samples.  The HDLC deframer is not in this kernel: the caller
// runs it over the slots (ops/demod.hdlc_scan).
//
// What bounds it on an H100: the same per-stream chain as the fused
// kernel (pipeline_compact.cu) without the deframer: 36 dependent float
// adds and ~10 integer ops of DPLL per sample, no parallelism inside the
// stream, so it is latency-bound per thread.  At 4096 streams the grid is
// 32 blocks of 128 threads: 32 of the 132 SMs busy.  A block of 49,152
// samples reads 403 MB of int16 and writes 50 MB of codes.
// Design: one thread per stream, all state in registers (the 36-float
// window shifted with static indices, the DPLL), the step functions of
// pipeline_step.cuh (the FIR rounds each product and partial sum once, no
// FMA, subnormals kept).  Input and output are time-major ([T, S] and
// [T/4, S]) so that a warp's loads and stores at one time step are
// neighbouring.  The codes are uint8.  The wrapper turns them into the
// [S, T/4] gbits/gvalid/gpos of the plain version with one transpose copy
// of the codes (a read and a write of 50 MB) and a few elementwise passes
// over [S, T/4].

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace {

using namespace gnuais;

__global__ void __launch_bounds__(128) frontend_kernel(
    const int16_t* __restrict__ x,        // [T, S] raw samples
    const float* __restrict__ hist,       // [S, 36] FIR history
    const int32_t* __restrict__ dpll_in,  // [3, S]: pll, prev, lastbit
    uint8_t* __restrict__ codes,          // [T/4, S]
    int32_t* __restrict__ dpll_out,       // [3, S]
    int S, int T, int n_valid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;

  float win[kFirLen];
#pragma unroll
  for (int i = 0; i < kFirLen; ++i) win[i] = hist[(size_t)s * kFirLen + i];
  DpllRegs d{dpll_in[s], dpll_in[S + s], dpll_in[2 * S + s]};

  const int nv = n_valid < T ? n_valid : T;   // samples past n_valid freeze
  const int n_groups = nv > 0 ? (nv + 3) / 4 : 0;
  const int all_groups = T / 4;
  for (int g = 0; g < n_groups; ++g) {
    uint8_t code = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * g + k;
      if (t < nv) {
        const float f = fir_exact(win);
#pragma unroll
        for (int i = 0; i < kFirLen - 1; ++i) win[i] = win[i + 1];
        win[kFirLen - 1] = static_cast<float>(x[(size_t)t * S + s]);
        int32_t bit;
        if (dpll_step(d, f, &bit)) code |= static_cast<uint8_t>(8 | (bit << 2) | k);
      }
    }
    codes[(size_t)g * S + s] = code;
  }
  for (int g = n_groups; g < all_groups; ++g) codes[(size_t)g * S + s] = 0;

  dpll_out[s] = d.pll;
  dpll_out[S + s] = d.prev;
  dpll_out[2 * S + s] = d.lastbit;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  T % 4 == 0.
extern "C" int gnuais_frontend(const void* x, const void* hist,
                               const void* dpll_in, void* codes,
                               void* dpll_out, int S, int T, int n_valid,
                               void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (S + kThreads - 1) / kThreads;
  frontend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), static_cast<uint8_t*>(codes),
      static_cast<int32_t*>(dpll_out), S, T, n_valid);
  return static_cast<int>(cudaGetLastError());
}
