// Fused decode kernel, compact landing, exact ("vpu") FIR.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_pipeline_kernel` in
// its compact configuration, called through `pipeline_fused_compact`:
// raw int16 samples -> 36-tap FIR (one-sample delay, carried history) ->
// DPLL slicer + NRZI -> 4-sample bit slots -> HDLC deframer -> each
// completed frame written at the stream's running count in dense slots,
// plus the new DPLL and HDLC carry.
//
// What bounds it on an H100: each stream is a long sequential chain
// (36 float multiply-adds, ~10 integer ops of DPLL per sample and a
// branchy deframer step every 4 samples) with no parallelism inside the
// stream, so the kernel is latency-bound per thread, not bandwidth-
// bound: one block of 49,152 samples is 98 KB per stream, read once.
// Design: one thread per stream, 128 threads per block, all state in
// registers (the 36-float FIR window shifted with static indices, the
// DPLL and HDLC variables, the 15-word register).  The input is
// time-major [T, S], so a warp's 32 loads at one time step are
// neighbouring.  A completed frame is written straight to global memory
// at [s, count]; there is no candidate buffer.  At 4096 streams the grid
// is 32 blocks, which fills about 32 of the 132 SMs with one warp group
// each: accepted for this first version.
//
// Frames: a completion is kept while its 64-slot chunk has held fewer
// than kMiniSlots completions, as in the exact chain (structurally
// always: completions are >= ~47 slots apart); a later one in the same
// chunk is counted in `over` instead.  count_raw keeps counting past F;
// slots at index >= F are not written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace {

using namespace gnuais;

__global__ void __launch_bounds__(128) pipeline_compact_kernel(
    const int16_t* __restrict__ x,        // [T, S]
    const float* __restrict__ hist,       // [S, 36]
    const int32_t* __restrict__ dpll_in,  // [3, S]: pll, prev, lastbit
    const int32_t* __restrict__ hdlc_in,  // [8, S]: HdlcState order
    const int32_t* __restrict__ reg_in,   // [S, 15] uint32 bit patterns
    int32_t* __restrict__ count_raw,      // [S]
    int32_t* __restrict__ words,          // [S, F, 15], zero-filled
    int32_t* __restrict__ fields,         // [3, S, F]: length, start, end, zero-filled
    int32_t* __restrict__ lost2_out,      // [S]
    int32_t* __restrict__ over_out,       // [S]
    int32_t* __restrict__ dpll_out,       // [3, S]
    int32_t* __restrict__ hdlc_out,       // [8, S]
    int32_t* __restrict__ reg_out,        // [S, 15]
    int S, int T, int n_valid, int block_base, int lost2_lo, int lost2_hi,
    int F) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;

  float win[kFirLen];
#pragma unroll
  for (int i = 0; i < kFirLen; ++i) win[i] = hist[(size_t)s * kFirLen + i];
  DpllRegs d{dpll_in[s], dpll_in[S + s], dpll_in[2 * S + s]};
  HdlcRegs h;
  h.state = hdlc_in[s];
  h.last = hdlc_in[S + s];
  h.ap = hdlc_in[2 * S + s];
  h.ns = hdlc_in[3 * S + s];
  h.ae = hdlc_in[4 * S + s];
  h.bs = hdlc_in[5 * S + s];
  h.bp = hdlc_in[6 * S + s];
  h.ds = hdlc_in[7 * S + s];
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    h.reg[w] = static_cast<uint32_t>(reg_in[(size_t)s * kRegWords + w]);

  int32_t count = 0, lost2 = 0, over = 0, chunk_count = 0;
  const int nv = n_valid < T ? n_valid : T;   // samples past n_valid freeze
  const int n_groups = nv > 0 ? (nv + 3) / 4 : 0;
  for (int g = 0; g < n_groups; ++g) {
    if (g % kHdlcChunk == 0) chunk_count = 0;
    bool gval = false;
    int32_t gbit = 0, gpos = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * g + k;
      if (t < nv) {
        const float f = fir_exact(win);
#pragma unroll
        for (int i = 0; i < kFirLen - 1; ++i) win[i] = win[i + 1];
        win[kFirLen - 1] = static_cast<float>(x[(size_t)t * S + s]);
        int32_t bit;
        if (dpll_step(d, f, &bit)) {   // at most one emission per group
          gval = true;
          gbit = bit;
          gpos = static_cast<int32_t>(static_cast<uint32_t>(block_base) +
                                      static_cast<uint32_t>(t));
        }
      }
    }
    if (!gval) continue;
    const SlotEvent ev = hdlc_step(h, gbit, gpos);
    if (ev.bad && gpos >= lost2_lo && gpos < lost2_hi) ++lost2;
    if (ev.emit) {
      if (chunk_count < kMiniSlots) {
        if (count < F) {
          const size_t slot = (size_t)s * F + count;
          int32_t* dst = words + slot * kRegWords;
#pragma unroll
          for (int w = 0; w < kRegWords; ++w) dst[w] = static_cast<int32_t>(h.reg[w]);
          fields[slot] = ev.flen;
          fields[(size_t)S * F + slot] = ev.start;
          fields[2 * (size_t)S * F + slot] = gpos;
        }
        ++count;
      } else {
        ++over;
      }
      ++chunk_count;
    }
  }

  count_raw[s] = count;
  lost2_out[s] = lost2;
  over_out[s] = over;
  dpll_out[s] = d.pll;
  dpll_out[S + s] = d.prev;
  dpll_out[2 * S + s] = d.lastbit;
  hdlc_out[s] = h.state;
  hdlc_out[S + s] = h.last;
  hdlc_out[2 * S + s] = h.ap;
  hdlc_out[3 * S + s] = h.ns;
  hdlc_out[4 * S + s] = h.ae;
  hdlc_out[5 * S + s] = h.bs;
  hdlc_out[6 * S + s] = h.bp;
  hdlc_out[7 * S + s] = h.ds;
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    reg_out[(size_t)s * kRegWords + w] = static_cast<int32_t>(h.reg[w]);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.
extern "C" int gnuais_pipeline_compact(
    const void* x, const void* hist, const void* dpll_in, const void* hdlc_in,
    const void* reg_in, void* count_raw, void* words, void* fields,
    void* lost2, void* over, void* dpll_out, void* hdlc_out, void* reg_out,
    int S, int T, int n_valid, int block_base, int lost2_lo, int lost2_hi,
    int F, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (S + kThreads - 1) / kThreads;
  pipeline_compact_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), static_cast<const int32_t*>(hdlc_in),
      static_cast<const int32_t*>(reg_in), static_cast<int32_t*>(count_raw),
      static_cast<int32_t*>(words), static_cast<int32_t*>(fields),
      static_cast<int32_t*>(lost2), static_cast<int32_t*>(over),
      static_cast<int32_t*>(dpll_out), static_cast<int32_t*>(hdlc_out),
      static_cast<int32_t*>(reg_out), S, T, n_valid, block_base, lost2_lo,
      lost2_hi, F);
  return static_cast<int>(cudaGetLastError());
}
