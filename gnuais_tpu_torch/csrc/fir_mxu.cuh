// The mxu FIR: one warp's 32 streams filtered a chunk of U = 32 samples
// at a time by one banded matrix product on the tensor cores.
//
// Replaces the FIR of the TPU kernel gnuais_tpu/ops/fused.py
// `_pipeline_kernel` in fir_mode "mxu" (fused.py:735-747, 767-768,
// 902-903): per unroll chunk, the [U, 36 + U] banded taps matrix A
// (A[k, k + i] = taps[i], `_fir_band_matrix`) times the window of 36
// history and U new samples, on the MXU.  Used by kernels B1 and B2
// (pipeline_kernel.cuh, Fir::kMxu) and by the probe fir_probe.cu, both
// through the chunk loop mxu_chunks.
//
// What bounds it: not the tensor cores' rate (168 multiply-adds a
// sample in 3xTF32) nor the bytes, but latency: with 32 warps of 4 per
// block at 4096 streams each scheduler holds one warp, and a chunk's
// loads, window move, operand splits and MMA chain follow one another.
// On an H100 80GB HBM3 (700 W) the staging and product alone take
// ~8.4 us a warp and chunk (fir_probe.cu: 12.9 ms at 4096 x 49,152),
// most of the mxu kernels' 13.4 ms; the chain after them is not the
// limit here.  What the mode changes against the vpu FIR is that a
// stream's 32 samples are loaded together, not one per chain step.
//
// Design, per warp and chunk:
// - The window is staged in shared memory time-major, win[row][stream]
//   (72 rows: 36 history, 32 samples, 4 zero rows to fill 9 k-tiles of
//   8; 40 floats a row, 32 streams and a pad): this is the B operand,
//   K = window row, N = stream.  Each lane writes its own stream's
//   column: the chunk's samples loaded from the time-major [T, S] input
//   (a warp's 32 loads at one time step neighbouring), and between
//   chunks the last 36 rows moved to the front.
// - A is staged once per block, split into its TF32 parts.
// - The product runs as WMMA m16n16k8 TF32 tiles with float32
//   accumulation, in 3xTF32: each operand v is split into
//   big = tf32(v) and small = tf32(v - big), and C accumulates
//   small(A) big(B) + big(A) small(B) + big(A) big(B).  Plain TF32 keeps
//   11 significant bits and int16 samples need 15, so one pass would
//   move slicer decisions; split, every sample is exact (|x - big| <= 16
//   is a TF32 value) and every tap keeps ~22 bits.  Row tile 0 (outputs
//   0..15) touches window rows 0..50 only and row tile 1 rows 16..66, so
//   each skips the two all-zero k-tiles of its band: 7 of 9.
// - C goes back to shared memory, out[k][stream], and lane s reads its
//   own stream's 32 filtered values from its column.
// The error bound against the exact FIR is MXU_BOUND in ops/fused.py.
// mma.sync through WMMA is enough at this size; wgmma, TMA and
// swizzled layouts are later work.

#pragma once

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "pipeline_step.cuh"

namespace gnuais {

constexpr int kMxuUnroll = 32;                  // U: samples per chunk
constexpr int kMxuRows = 72;                    // 36 + U window rows, 9 k-tiles
constexpr int kMxuLd = 40;                      // floats per shared row

// The band matrix A [U, 72] in its two TF32 parts; one per block.
struct MxuBand {
  float big[kMxuUnroll * kMxuRows];
  float small[kMxuUnroll * kMxuRows];
};

// One warp's window (the B operand) and filtered outputs.
struct MxuWarp {
  float win[kMxuRows * kMxuLd];                 // [row][stream]
  float out[kMxuUnroll * kMxuLd];               // [sample][stream]
};

// Dynamic shared memory of a block of `threads` threads.
constexpr size_t mxu_shared_bytes(int threads) {
  return sizeof(MxuBand) + (threads / 32) * sizeof(MxuWarp);
}

__device__ __forceinline__ unsigned char* mxu_shared() {
  extern __shared__ __align__(128) unsigned char gnuais_mxu_smem[];
  return gnuais_mxu_smem;
}

// Fills the block's band matrix; every thread of the block takes part
// and the caller synchronises the block after it.
__device__ __forceinline__ void mxu_band_init(MxuBand& band) {
  constexpr float taps[kFirLen] = {GNUAIS_FIR_TAPS};
  for (int i = threadIdx.x; i < kMxuUnroll * kMxuRows; i += blockDim.x) {
    const int tap = i % kMxuRows - i / kMxuRows;
    const float v = (tap >= 0 && tap < kFirLen) ? taps[tap] : 0.0f;
    const float hi = nvcuda::wmma::__float_to_tf32(v);
    band.big[i] = hi;
    band.small[i] = nvcuda::wmma::__float_to_tf32(v - hi);
  }
}

// Window rows 0..35 from the carried history of this lane's stream
// (hist: its 36 floats, or nullptr for a lane past the last stream,
// which takes zeros) and the zero rows 68..71.
__device__ __forceinline__ void mxu_stage_history(MxuWarp& w, int lane,
                                                  const float* hist) {
#pragma unroll
  for (int i = 0; i < kFirLen; ++i)
    w.win[i * kMxuLd + lane] = hist != nullptr ? hist[i] : 0.0f;
#pragma unroll
  for (int r = kFirLen + kMxuUnroll; r < kMxuRows; ++r)
    w.win[r * kMxuLd + lane] = 0.0f;
}

// The window of the chunk starting at sample t0: for t0 > 0 the last 36
// rows of the previous window move to rows 0..35, then rows 36..67 take
// samples t0..t0+31 of stream s from the time-major [T, S] input x
// (zero past T, and for s < 0, a lane past the last stream).
__device__ __forceinline__ void mxu_stage_chunk(MxuWarp& w, int lane,
                                                const int16_t* x, int S,
                                                int T, int t0, int s) {
  if (t0 > 0) {
#pragma unroll
    for (int i = 0; i < kFirLen; ++i)   // rows 32..35 are read before written
      w.win[i * kMxuLd + lane] = w.win[(i + kMxuUnroll) * kMxuLd + lane];
  }
  float v[kMxuUnroll];
#pragma unroll
  for (int k = 0; k < kMxuUnroll; ++k) {
    const int t = t0 + k;
    v[k] = (s >= 0 && t < T)
               ? static_cast<float>(__ldg(x + (size_t)t * S + s)) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kMxuUnroll; ++k)
    w.win[(kFirLen + k) * kMxuLd + lane] = v[k];
}

// w.out = A @ w.win over the warp's 32 streams: warp-collective, every
// lane of the warp calls it after the window is staged and synchronised.
__device__ __forceinline__ void mxu_product(const MxuBand& band,
                                            MxuWarp& w) {
  using namespace nvcuda;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                               wmma::precision::tf32, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                               wmma::precision::tf32, wmma::row_major>;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.0f);
#pragma unroll
  for (int kt = 0; kt < kMxuRows / 8; ++kt) {
    FragB bb[2], bs[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wmma::load_matrix_sync(bb[n], w.win + kt * 8 * kMxuLd + n * 16, kMxuLd);
#pragma unroll
      for (int e = 0; e < bb[n].num_elements; ++e) {
        const float v = bb[n].x[e];
        const float hi = wmma::__float_to_tf32(v);
        bb[n].x[e] = hi;
        bs[n].x[e] = wmma::__float_to_tf32(v - hi);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (kt < 2 * m || kt > 2 * m + 6) continue;   // an all-zero band tile
      FragA ab, as;
      const int at = m * 16 * kMxuRows + kt * 8;
      wmma::load_matrix_sync(ab, band.big + at, kMxuRows);
      wmma::load_matrix_sync(as, band.small + at, kMxuRows);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::mma_sync(acc[m][n], as, bb[n], acc[m][n]);
        wmma::mma_sync(acc[m][n], ab, bs[n], acc[m][n]);
        wmma::mma_sync(acc[m][n], ab, bb[n], acc[m][n]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wmma::store_matrix_sync(w.out + m * 16 * kMxuLd + n * 16, acc[m][n],
                              kMxuLd, wmma::mem_row_major);
}

// The chunk loop of one warp over samples 0..nv-1 of the time-major
// [T, S] input x, nv the same on every lane (the block's band filled and
// synchronised before): per chunk every lane stages its stream's window,
// the warp runs the product, and on a live lane consume(t0, f) takes the
// chunk's filtered values, sample t0 + k at f[k * kMxuLd].  A lane past
// the last stream (s < 0, hist nullptr) stages zeros, takes part in the
// product and consumes nothing.  Kernels B1/B2 and the probe share it.
template <typename Consume>
__device__ __forceinline__ void mxu_chunks(const MxuBand& band, MxuWarp& w,
                                           const int16_t* x, int S, int T,
                                           int nv, int s, const float* hist,
                                           Consume&& consume) {
  const int lane = threadIdx.x % 32;
  mxu_stage_history(w, lane, hist);
  for (int t0 = 0; t0 < nv; t0 += kMxuUnroll) {
    mxu_stage_chunk(w, lane, x, S, T, t0, s);
    __syncwarp();
    mxu_product(band, w);
    __syncwarp();
    if (s >= 0) consume(t0, w.out + lane);
    __syncwarp();   // the next chunk rewrites the window and the outputs
  }
}

}  // namespace gnuais
