// Kernel B2: the fused decode step with frame candidates.
//
// Replaces the TPU kernel gnuais_tpu/ops/fused.py `_pipeline_kernel`
// called through `pipeline_fused`: the same decode as B1, but a
// completed frame lands in the candidate slots of its 64-slot HDLC
// chunk, K = 2 * ceil(T / 256) slots per stream (the TPU kernel's
// per-chunk mini buffers, MINI_SLOTS = 2), with cand_valid set, for
// demod.compact_candidates to compact.  The FIR is the exact one ("vpu"),
// the main-lobe one ("lobe") or the tensor-core one ("mxu",
// fir_mxu.cuh); or none, on float32 samples filtered before the call
// (prefiltered=True, with_fir=False at fused.py:645, 709, 729-731; the
// history passed through, :1238-1240), whose one producer warp only
// copies the samples into the ring (pipeline_ring.cuh f32_fetch).  The
// kernel body (producer and consumer warps around a ring in shared
// memory), its landing, what bounds it and its design are in
// pipeline_kernel.cuh.  Candidates are rare (tens per stream against
// K = 384 slots at T = 49,152), so each field is written straight to
// global memory; the wrapper zero-fills the outputs and a coalesced
// layout is later work.
//
// What bounds the prefiltered mode on an H100: it reads 4 bytes a
// sample (805 MB at S = 4096, T = 49,152: 0.24 ms at 3.35 TB/s) and does
// no float work; it runs in the time of the FIR modes, whatever the
// number of copy warps (PERF.md), so the producers do not set its pace.

#include "pipeline_kernel.cuh"

// Launches the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  fir_mode: 0 exact, 1 lobe,
// 2 mxu, 3 prefiltered (x float32); x is time-major [T, pitch]
// (row_major 0) or row-major [S, pitch] (row_major 1).
extern "C" int gnuais_pipeline_fused(
    const void* x, const void* hist, const void* dpll_in, const void* hdlc_in,
    const void* reg_in, void* cand_valid, void* words, void* fields,
    void* lost2, void* over, void* dpll_out, void* hdlc_out, void* reg_out,
    int S, int T, int n_valid, int block_base, int lost2_lo, int lost2_hi,
    int K, int fir_mode, int row_major, int pitch, void* stream) {
  gnuais::PipelineArgs a{
      static_cast<const int16_t*>(x), static_cast<const float*>(hist),
      static_cast<const int32_t*>(dpll_in), static_cast<const int32_t*>(hdlc_in),
      static_cast<const int32_t*>(reg_in), nullptr,
      static_cast<uint8_t*>(cand_valid), static_cast<int32_t*>(words),
      static_cast<int32_t*>(fields), static_cast<int32_t*>(lost2),
      static_cast<int32_t*>(over), static_cast<int32_t*>(dpll_out),
      static_cast<int32_t*>(hdlc_out), static_cast<int32_t*>(reg_out), S, T,
      n_valid, block_base, lost2_lo, lost2_hi, K, row_major, pitch};
  return gnuais::launch_candidates<0>(a, fir_mode, stream);
}
