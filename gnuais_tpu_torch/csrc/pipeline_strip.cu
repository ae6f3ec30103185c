// Kernel B2 with pieces stripped: the counterpart of the JAX kernel's
// strip= flags (gnuais_tpu/ops/fused.py `_pipeline_kernel`, strip at
// :1041), the perf bisection that tools/diag_strip.py runs and
// gnuais_tpu_torch/diag_strip.py runs here.  An instrument: a stripped
// kernel's outputs are not the decode's by design.
//
// Built on its own, one library for each strip set, at the first call
// that asks for it (ops/_build.strip_library), with -DGNUAIS_STRIP=<mask>
// the bits of kStrip (pipeline_kernel.cuh): the main library and its
// build do not carry these instantiations.  Each library holds B2 in
// every FIR mode (exact, lobe, mxu, prefiltered).
//
// The flags, and what each leaves out of this kernel's design (the JAX
// kernel keeps completed frames in per-chunk mini buffers in VMEM and
// flushes them to HBM once a chunk; this one writes each frame straight
// to global memory, so JAX's "snap" and "flush" map to the nearest
// pieces of that one store):
// - fir (kStripFir, fused.py:733): no FIR; the producers write the raw
//   samples cast to float32 (prefiltered input is copied as it is), so
//   the mxu mode runs no tensor-core product;
// - hdlc (kStripHdlc, :813-816): no slot section: the consumer runs the
//   DPLL alone; the HDLC carry goes out as it came in, no frame, lost2
//   and over 0;
// - book (kStripBook, :833-837): lost2 and over are not counted (0);
// - shift (kStripShift, :842-843): the deframer never appends to its
//   register (hdlc_step<false>): the state and frame fields as
//   unstripped, the register and the frames' words as they came in;
// - snap (kStripSnap, :856, the copy into the mini buffer): a frame's
//   words and fields are not written, its candidate flag is (as JAX's
//   chunk counts still reach HBM);
// - flush (kStripFlush, :966, the store of the mini buffers and counts):
//   nothing of a frame is written, its candidate flag neither.

#include "pipeline_kernel.cuh"

#ifndef GNUAIS_STRIP
#error "build with -DGNUAIS_STRIP=<mask of the strip flags>"
#endif

// Launches the stripped B2 on `stream` and returns cudaGetLastError().
// Arguments as gnuais_pipeline_fused (pipeline_fused.cu), fir_mode 0-3.
extern "C" int gnuais_pipeline_strip(
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
  return gnuais::launch_candidates<GNUAIS_STRIP>(a, fir_mode, stream);
}

// The strip set this library was built with.
extern "C" int gnuais_pipeline_strip_mask() { return GNUAIS_STRIP; }
