// Kernel B1: the fused decode step with dense frame slots.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_pipeline_kernel` in
// its compact configuration, called through `pipeline_fused_compact`:
// each completed frame is written at the stream's running count in F
// dense slots (slots at index >= F are not written; count_raw keeps
// counting past F), so no candidate buffer exists.  The FIR is the
// exact one ("vpu"), the main-lobe one ("lobe") or the tensor-core
// one ("mxu", fir_mxu.cuh).  The kernel body (a consumer warp running
// the chain of 32 streams, fed by FIR producer warps through a ring in
// shared memory), what bounds it and its launch shape are in
// pipeline_kernel.cuh.

#include "pipeline_kernel.cuh"

namespace {

using gnuais::Fir;
using gnuais::launch_pipeline_mode;

int launch_dense(const gnuais::PipelineArgs& a, int fir_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fir_mode == 0) return launch_pipeline_mode<Fir::kExact, false>(a, st);
  if (fir_mode == 1) return launch_pipeline_mode<Fir::kLobe, false>(a, st);
  if (fir_mode == 2) return launch_pipeline_mode<Fir::kMxu, false>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  fir_mode: 0 exact, 1 lobe,
// 2 mxu; x is time-major [T, pitch] (row_major 0) or row-major
// [S, pitch] (row_major 1).
extern "C" int gnuais_pipeline_compact(
    const void* x, const void* hist, const void* dpll_in, const void* hdlc_in,
    const void* reg_in, void* count_raw, void* words, void* fields,
    void* lost2, void* over, void* dpll_out, void* hdlc_out, void* reg_out,
    int S, int T, int n_valid, int block_base, int lost2_lo, int lost2_hi,
    int F, int fir_mode, int row_major, int pitch, void* stream) {
  gnuais::PipelineArgs a{
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), static_cast<const int32_t*>(hdlc_in),
      static_cast<const int32_t*>(reg_in), static_cast<int32_t*>(count_raw),
      nullptr, static_cast<int32_t*>(words), static_cast<int32_t*>(fields),
      static_cast<int32_t*>(lost2), static_cast<int32_t*>(over),
      static_cast<int32_t*>(dpll_out), static_cast<int32_t*>(hdlc_out),
      static_cast<int32_t*>(reg_out), S, T, n_valid, block_base, lost2_lo,
      lost2_hi, F, row_major, pitch};
  return launch_dense(a, fir_mode, stream);
}

// The launch shape of B1 and B2 in fir_mode (0 exact, 1 lobe, 2 mxu;
// 3 B2's prefiltered mode): out[0..3] = producer
// warps, ring stages, warps a block, dynamic shared memory a block in
// bytes.  Returns 0, or cudaErrorInvalidValue for an unknown mode.
extern "C" int gnuais_pipeline_shape(int fir_mode, int* out) {
  using gnuais::Fir;
  if (fir_mode < 0 || fir_mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int p[4] = {gnuais::kProducers<Fir::kExact>, gnuais::kProducers<Fir::kLobe>,
                    gnuais::kProducers<Fir::kMxu>, gnuais::kProducers<Fir::kNone>};
  const size_t smem[4] = {gnuais::pipeline_shared_bytes<Fir::kExact>(),
                          gnuais::pipeline_shared_bytes<Fir::kLobe>(),
                          gnuais::pipeline_shared_bytes<Fir::kMxu>(),
                          gnuais::pipeline_shared_bytes<Fir::kNone>()};
  out[0] = p[fir_mode];
  out[1] = gnuais::kStages;
  out[2] = 1 + p[fir_mode];
  out[3] = static_cast<int>(smem[fir_mode]);
  return 0;
}
