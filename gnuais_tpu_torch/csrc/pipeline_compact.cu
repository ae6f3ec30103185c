// Kernel B1: the fused decode step with dense frame slots.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_pipeline_kernel` in
// its compact configuration, called through `pipeline_fused_compact`:
// each completed frame is written at the stream's running count in F
// dense slots (slots at index >= F are not written; count_raw keeps
// counting past F), so no candidate buffer exists.  The FIR is the
// exact one ("vpu"), the main-lobe one ("lobe") or the tensor-core
// one ("mxu", fir_mxu.cuh).  The per-stream body,
// what bounds it and its design are in pipeline_kernel.cuh; at 4096
// streams the grid is 32 blocks of 128 threads, which fills about 32 of
// the 132 SMs with one warp group each: accepted for this version.

#include "pipeline_kernel.cuh"

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  fir_mode: 0 exact, 1 lobe,
// 2 mxu.
extern "C" int gnuais_pipeline_compact(
    const void* x, const void* hist, const void* dpll_in, const void* hdlc_in,
    const void* reg_in, void* count_raw, void* words, void* fields,
    void* lost2, void* over, void* dpll_out, void* hdlc_out, void* reg_out,
    int S, int T, int n_valid, int block_base, int lost2_lo, int lost2_hi,
    int F, int fir_mode, void* stream) {
  gnuais::PipelineArgs a{
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), static_cast<const int32_t*>(hdlc_in),
      static_cast<const int32_t*>(reg_in), static_cast<int32_t*>(count_raw),
      nullptr, static_cast<int32_t*>(words), static_cast<int32_t*>(fields),
      static_cast<int32_t*>(lost2), static_cast<int32_t*>(over),
      static_cast<int32_t*>(dpll_out), static_cast<int32_t*>(hdlc_out),
      static_cast<int32_t*>(reg_out), S, T, n_valid, block_base, lost2_lo,
      lost2_hi, F};
  return gnuais::launch_pipeline<false>(a, fir_mode, stream);
}
