// The mxu FIR alone: a test instrument, on no decode path.
//
// Runs the chunk loop of fir_mxu.cuh (mxu_chunks: the staging and the
// tensor-core product), the one kernels B1 and B2 run in fir_mode
// "mxu", over a time-major
// [T, S] int16 block with a carried [S, 36] float32 history, and writes
// the filtered values time-major [T, S] float32 instead of feeding them
// to the DPLL.  The card can so hold the tensor-core FIR itself against
// ops/fir.fir_mxu and fir_exact with a number, and not only through the
// frames it decodes.  Bound by its bytes (2 in, 4 out a sample); the
// design is fir_mxu.cuh's, one warp per 32 streams, 4 warps a block.

#include "fir_mxu.cuh"

namespace {

constexpr int kProbeThreads = 128;

__global__ void __launch_bounds__(kProbeThreads)
fir_probe_kernel(const int16_t* x, const float* hist, float* out, int S,
                 int T) {
  using namespace gnuais;
  unsigned char* smem = mxu_shared();
  MxuBand& band = *reinterpret_cast<MxuBand*>(smem);
  MxuWarp& w = reinterpret_cast<MxuWarp*>(smem + sizeof(MxuBand))[threadIdx.x / 32];
  mxu_band_init(band);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < S;
  mxu_chunks(band, w, x, S, T, T, live ? s : -1,
             live ? hist + (size_t)s * kFirLen : nullptr,
             [&](int t0, const float* f) {
    for (int k = 0; k < kMxuUnroll && t0 + k < T; ++k)
      out[(size_t)(t0 + k) * S + s] = f[k * kMxuLd];
  });
}

}  // namespace

// Launches the probe on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.
extern "C" int gnuais_fir_probe(const void* x, const void* hist, void* out,
                                int S, int T, void* stream) {
  constexpr size_t smem = gnuais::mxu_shared_bytes(kProbeThreads);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kProbeThreads - 1) / kProbeThreads;
  fir_probe_kernel<<<blocks, kProbeThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<float*>(out), S, T);
  return static_cast<int>(cudaGetLastError());
}
