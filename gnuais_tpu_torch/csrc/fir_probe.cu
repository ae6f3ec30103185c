// The mxu FIR alone: a test instrument, on no decode path.
//
// Runs the producer stage of kernels B1 and B2 in fir_mode "mxu"
// (fir_mxu.cuh mxu_produce: the raw copies, the staging and the
// tensor-core product, kMxuProducers warps a block feeding the ring of
// pipeline_ring.cuh) over a row-major [S, T] int16 block with a carried
// [S, 36] float32 history; its consumer warp writes the filtered values
// out, row-major [S, T] float32, instead of running the chain.  The card
// can so hold the tensor-core FIR itself against ops/fir.fir_mxu and
// fir_exact with a number, and time the stage that feeds B1/B2's chain.
// Bound by its bytes (2 in, 4 out a sample).

#include "fir_mxu.cuh"

namespace {

using gnuais::kChunk;
using gnuais::kMxuProducers;

constexpr int kProbeThreads = 32 * (1 + kMxuProducers);

__global__ void __launch_bounds__(kProbeThreads)
fir_probe_kernel(const gnuais::RingInput in, float* out) {
  using namespace gnuais;
  MxuShared& sh = *reinterpret_cast<MxuShared*>(block_shared());
  ring_init(sh.r.ring);
  mxu_band_init(sh.band);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int s0 = blockIdx.x * kChunk;
  const int s = s0 + threadIdx.x % 32;
  const int n_chunks = (in.T + kChunk - 1) / kChunk;
  if (warp == 0) {
    ring_consume(sh.r.ring, n_chunks, [&](int t0, const float* f) {
      if (s >= in.S) return;
      for (int k = 0; k < kChunk && t0 + k < in.T; ++k)
        out[(size_t)s * in.T + t0 + k] = f[k * 32];
    });
    return;
  }
  mxu_produce(sh, in, s0, n_chunks, warp - 1,
              s < in.S ? in.hist + (size_t)s * kFirLen : nullptr);
}

}  // namespace

// Launches the probe on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  x: [S, pitch] row-major.
extern "C" int gnuais_fir_probe(const void* x, const void* hist, void* out,
                                int S, int T, int pitch, void* stream) {
  constexpr size_t smem = sizeof(gnuais::MxuShared);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const gnuais::RingInput in{static_cast<const int16_t*>(x),
                             static_cast<const float*>(hist), S, T, pitch,
                             true, gnuais::ring_vec_ok(x, pitch)};
  const int blocks = (S + kChunk - 1) / kChunk;
  fir_probe_kernel<<<blocks, kProbeThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
