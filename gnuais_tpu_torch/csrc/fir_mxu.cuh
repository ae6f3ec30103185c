// The mxu FIR: one warp's 32 streams filtered a chunk of U = 32 samples
// at a time by one banded matrix product on the tensor cores.
//
// Replaces the FIR of the TPU kernel gnuais_tpu/ops/fused.py
// `_pipeline_kernel` in fir_mode "mxu" (fused.py:735-747, 767-768,
// 902-903): per unroll chunk, the [U, 36 + U] banded taps matrix A
// (A[k, k + i] = taps[i], `_fir_band_matrix`) times the window of 36
// history and U new samples, on the MXU.  Here it is the work of a
// producer warp of the ring (pipeline_ring.cuh) in kernels B1 and B2
// (pipeline_kernel.cuh, Fir::kMxu) and in the probe fir_probe.cu: the
// warp takes its chunk's raw window out of its copy buffer, stages it
// (mxu_window) and writes the product straight into the chunk's ring
// stage (mxu_product), while the consumer warp runs the chain.
//
// What bounds it: not the tensor cores' rate (168 multiply-adds a
// sample in 3xTF32) nor the bytes, but latency: a chunk's window move,
// operand splits and the 21-deep MMA chain of each output tile follow
// one another, so several producer warps work on different chunks.
//
// Design, per producer warp and chunk:
// - The window is staged in shared memory time-major, win[row][stream]
//   (72 rows: 36 history, 32 samples, 4 zero rows to fill 9 k-tiles of
//   8; 40 floats a row, 32 streams and a pad): this is the B operand,
//   K = window row, N = stream.  Each lane writes its own stream's
//   column from the raw window (a lane past the last stream: zeros).
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
// - C goes to the ring stage, out[sample][stream].
// The error bound against the exact FIR is MXU_BOUND in ops/fused.py.
// mma.sync through WMMA is enough at this size; wgmma is later work.

#pragma once

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "pipeline_ring.cuh"

namespace gnuais {

constexpr int kMxuUnroll = 32;                  // U: samples per chunk
constexpr int kMxuRows = 72;                    // 36 + U window rows, 9 k-tiles
constexpr int kMxuLd = 40;                      // floats per shared row

// Producer warps a consumer warp has in the mxu mode: a chunk's product
// takes a warp longer than the consumer's chain over it.
constexpr int kMxuProducers = 3;

// The band matrix A [U, 72] in its two TF32 parts; one per block.
struct alignas(128) MxuBand {
  float big[kMxuUnroll * kMxuRows];
  float small[kMxuUnroll * kMxuRows];
};

// One producer warp's window (the B operand), [row][stream].
struct alignas(128) MxuWindow {
  float win[kMxuRows * kMxuLd];
};

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

// The zero rows 68..71 of the window, once per producer warp.
__device__ __forceinline__ void mxu_window_init(MxuWindow& w, int lane) {
#pragma unroll
  for (int r = kFirLen + kMxuUnroll; r < kMxuRows; ++r)
    w.win[r * kMxuLd + lane] = 0.0f;
}

// Rows 0..67 of the window from this lane's raw column v (v[r]: sample
// t0 - 40 + r, pipeline_ring.cuh raw_column): row i is sample t0 - 36 + i.
__device__ __forceinline__ void mxu_window(MxuWindow& w, int lane,
                                           const float (&v)[kRawLen]) {
#pragma unroll
  for (int i = 0; i < kFirLen + kMxuUnroll; ++i)
    w.win[i * kMxuLd + lane] = v[kRawLead - kFirLen + i];
}

// out = A @ w.win over the warp's 32 streams, out[sample * ldo + stream]:
// warp-collective, every lane of the warp calls it after the window is
// staged and synchronised.
__device__ __forceinline__ void mxu_product(const MxuBand& band,
                                            const MxuWindow& w, float* out,
                                            int ldo) {
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
      wmma::store_matrix_sync(out + m * 16 * ldo + n * 16, acc[m][n], ldo,
                              wmma::mem_row_major);
}

// The block's shared memory in the mxu mode: the ring, the producers'
// copy buffers, the band and the producers' windows.
struct MxuShared {
  RingShared<kMxuProducers> r;
  MxuBand band;
  MxuWindow win[kMxuProducers];
};

// Producer warp p's loop (pipeline_ring.cuh ring_produce) in the mxu
// mode, the block's band filled and synchronised before: each chunk's
// window staged from the raw copy, the product written into its stage.
// hist: this lane's stream's 36 floats, nullptr past the last stream.
__device__ __forceinline__ void mxu_produce(MxuShared& sh, const RingInput& in,
                                            int s0, int n_chunks, int p,
                                            const float* hist) {
  const int lane = threadIdx.x % 32;
  MxuWindow& w = sh.win[p];
  mxu_window_init(w, lane);
  ring_produce(sh.r.ring, sh.r.raw[p], in, s0, n_chunks, p, kMxuProducers,
               [&](int t0) {
                 float v[kRawLen];
                 raw_column(sh.r.raw[p], in.row_major, lane, t0, hist, v);
                 mxu_window(w, lane, v);
               },
               [&](float* stage) { mxu_product(sh.band, w, stage, kChunk); });
}

}  // namespace gnuais
