// The HDLC deframer kernel: bit slots -> frame candidates and the new
// deframer carry.
//
// Replaces the deframer that the JAX package compiles through XLA:
// gnuais_tpu/ops/demod.py `hdlc_scan` (a chunked lax.scan, not a Pallas
// kernel), which runs after the front-end kernels B3 (frontend.cu) and
// B4 (dpll.cu) and in the exact chain.  Per stream, over its bit slots:
// the 5-state deframer with flag hunt, destuffing, the 449-bit cap and
// the 15 x 32-bit register (hdlc_step, pipeline_step.cuh); a completed
// frame lands in the candidate slots of its 64-slot chunk, at most
// kMiniSlots = 2 a chunk, a later one counted in `over`, and wrong-size
// stops at a position in [lost2_lo, lost2_hi) count in `lost2`: kernel
// B2's candidate slots, each frame written at its emission slot
// (slot_step<true>, pipeline_kernel.cuh; B2 writes the same frames once
// after their 32-sample chunk), so that demod.compact_candidates runs on
// its output as it does after B2.
//
// Three input forms, each read where the caller holds it:
// - group codes [M, pitch] uint8, time-major (B3's output): one byte a
//   4-sample group, valid << 3 | bit << 2 | offset, at sample
//   block_base + 4g + offset;
// - sample codes [T, pitch] uint8, time-major (B4's output): one byte a
//   sample, 2 + bit on a DPLL emission, else 0.  A 4-sample group holds
//   at most one emission (demod.group_reduce_bits), so the kernel
//   reduces each group itself: slot g is samples 4g .. 4g + 3;
// - slots: bits int32, valid uint8 and positions int32, each [S, pitch]
//   row-major (any caller of demod.hdlc_scan_candidates).
// Invalid slots (and, for the codes, samples past n_valid, which the
// front ends write as 0) freeze the state.
//
// What bounds it on an H100: each stream is one sequential chain of
// branchy deframer steps, one a slot, with no parallelism inside the
// stream (the roofline kernel R1 spends ~21.5 ns of each sample step on
// the deframer, ~86 ns a slot: 1.06 ms for 12,288 slots); the codes are
// 50 MB (group) or 201 MB (sample) at 4096 x 49,152 samples.
// Design: one lane a stream, its state and register in registers, one
// warp a block (128 blocks at 4096 streams, one an SM).  The lanes of a
// warp read 32 neighbouring streams' codes, so a tile of 32 slots of the
// block's 32 streams is a contiguous 32-byte piece of each row: the warp
// copies tiles into a ring of kTiles tiles in shared memory with
// cp.async, kAhead tiles ahead of the one it deframes, and each lane
// reads its stream's column from there, one slot ahead of its chain.
// A host build (gnuais_tpu_torch/hostbuild) compiles the same source as
// C++.

#include "pipeline_kernel.cuh"

namespace {

using namespace gnuais;

enum class Form { kGroupCodes = 0, kSampleCodes = 1, kSlots = 2 };

constexpr int kTile = 32;    // slots a tile
constexpr int kTiles = 8;    // tiles in the ring
constexpr int kAhead = 6;    // tiles in flight beyond the one awaited (< kTiles)

// Rows of the codes a tile covers: a slot is one row of group codes and
// four rows of sample codes.
template <Form kForm>
constexpr int kTileRows = kForm == Form::kSampleCodes ? 4 * kTile : kTile;

template <Form kForm>
struct alignas(16) TileRing {
  uint8_t tile[kTiles][kTileRows<kForm> * 32];   // [row][stream]
};

struct HdlcInput {
  const uint8_t* codes;    // [rows, pitch]: the codes forms
  const int32_t* bits;     // [S, pitch]: the slots form
  const uint8_t* valid;
  const int32_t* pos;
  int M;                   // bit slots a stream
  int rows;                // rows of codes: M (group) or T (sample)
  int pitch;
  int block_base;
  bool vec;                // 16-byte copies allowed (pointer and pitch aligned)
};

// Issues this lane's part of the copy of tile k (rows k * kTileRows ..,
// streams s0 .. s0 + 31) into `dst`: pieces of 16 streams of one row,
// cp.async where the piece lies inside the input and in.vec, byte by
// byte otherwise, zero outside the input.
template <Form kForm>
__device__ __forceinline__ void tile_fetch(uint8_t* dst, const HdlcInput& in,
                                           int S, int s0, int k, int lane) {
  constexpr int kRows = kTileRows<kForm>;
#pragma unroll
  for (int j = 0; j < kRows * 2 / 32; ++j) {
    const int c = lane + 32 * j;
    const int row = c / 2, half = c % 2;
    const int r = k * kRows + row;
    const int s = s0 + 16 * half;
    uint8_t* d = dst + row * 32 + 16 * half;
    const uint8_t* src = in.codes + (size_t)r * in.pitch + s;
    if (in.vec && r < in.rows && s + 16 <= S) {
      copy16_async(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        d[e] = (r < in.rows && s + e < S) ? src[e] : uint8_t(0);
    }
  }
  copy_commit();
}

// Slot q of a tile from this lane's column `col` of it: (valid, bit,
// offset in its 4-sample group) packed as a group code.
template <Form kForm>
__device__ __forceinline__ uint32_t tile_code(const uint8_t* col, int q) {
  if constexpr (kForm == Form::kGroupCodes) {
    return col[q * 32];
  } else {
    uint32_t code = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const uint32_t c = col[(4 * q + k) * 32];
      if (c >= 2) code = 8u | ((c & 1u) << 2) | static_cast<uint32_t>(k);
    }
    return code;
  }
}

template <Form kForm>
__global__ void __launch_bounds__(32) hdlc_kernel(const PipelineArgs a,
                                                  const HdlcInput in) {
  const int lane = threadIdx.x % 32;
  const int s0 = blockIdx.x * 32;
  const int s = s0 + lane;
  const bool live = s < a.S;
  StreamRegs r;
  if (live) load_hdlc_carry(a, s, r);
  if constexpr (kForm == Form::kSlots) {
    if (live) {
      const size_t row = (size_t)s * in.pitch;
#pragma unroll 1
      for (int g = 0; g < in.M; ++g)
        slot_step<true>(a, s, g, in.valid[row + g] != 0, in.bits[row + g],
                        in.pos[row + g], r);
    }
  } else {
    auto& ring = *reinterpret_cast<TileRing<kForm>*>(block_shared());
    const int n_tiles = (in.M + kTile - 1) / kTile;
    const uint32_t base = static_cast<uint32_t>(in.block_base);
    // every lane commits one copy group a tile, empty past the end, so
    // that copy_wait_pending<kAhead> always means "tile k has landed"
#pragma unroll 1
    for (int k = 0; k < kAhead; ++k) {
      if (k < n_tiles)
        tile_fetch<kForm>(ring.tile[k % kTiles], in, a.S, s0, k, lane);
      else
        copy_commit();
    }
#pragma unroll 1
    for (int k = 0; k < n_tiles; ++k) {
      __syncwarp();   // every lane is done with the tile the copy overwrites
      if (k + kAhead < n_tiles)
        tile_fetch<kForm>(ring.tile[(k + kAhead) % kTiles], in, a.S, s0,
                          k + kAhead, lane);
      else
        copy_commit();
      copy_wait_pending<kAhead>();
      __syncwarp();   // the tile's other pieces, copied by the other lanes
      if (!live) continue;
      const uint8_t* col = ring.tile[k % kTiles] + lane;
      const int n = in.M - k * kTile < kTile ? in.M - k * kTile : kTile;
      uint32_t next = tile_code<kForm>(col, 0);
#pragma unroll 1
      for (int q = 0; q < n; ++q) {
        const uint32_t code = next;
        if (q + 1 < n) next = tile_code<kForm>(col, q + 1);
        const int g = k * kTile + q;
        const int32_t gpos = static_cast<int32_t>(
            base + 4u * static_cast<uint32_t>(g) + (code & 3u));
        slot_step<true>(a, s, g, (code & 8u) != 0,
                        static_cast<int32_t>((code >> 2) & 1u), gpos, r);
      }
    }
  }
  if (live) store_hdlc_carry<true>(a, s, r);
}

template <Form kForm>
int launch_hdlc(const PipelineArgs& a, const HdlcInput& in, cudaStream_t st) {
  const size_t smem = kForm == Form::kSlots ? 0 : sizeof(TileRing<kForm>);
  const cudaError_t err = cudaFuncSetAttribute(
      hdlc_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.S + 31) / 32;
  hdlc_kernel<kForm><<<blocks, 32, smem, st>>>(a, in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the deframer on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  form: 0 group codes, 1
// sample codes (codes [rows, pitch] uint8), 2 slots (bits, valid, pos
// [S, pitch]); M bit slots a stream, K = 2 * ceil(M / 64) candidate
// slots; the candidate outputs zero-filled by the caller.
extern "C" int gnuais_hdlc(
    const void* codes, const void* bits, const void* valid, const void* pos,
    const void* hdlc_in, const void* reg_in, void* cand_valid, void* words,
    void* fields, void* lost2, void* over, void* hdlc_out, void* reg_out,
    int S, int M, int rows, int pitch, int form, int block_base,
    int lost2_lo, int lost2_hi, int K, void* stream) {
  gnuais::PipelineArgs a{
      nullptr, nullptr, nullptr, static_cast<const int32_t*>(hdlc_in),
      static_cast<const int32_t*>(reg_in), nullptr,
      static_cast<uint8_t*>(cand_valid), static_cast<int32_t*>(words),
      static_cast<int32_t*>(fields), static_cast<int32_t*>(lost2),
      static_cast<int32_t*>(over), nullptr, static_cast<int32_t*>(hdlc_out),
      static_cast<int32_t*>(reg_out), S, 0, 0, block_base, lost2_lo, lost2_hi,
      K, 0, 0};
  const HdlcInput in{static_cast<const uint8_t*>(codes),
                     static_cast<const int32_t*>(bits),
                     static_cast<const uint8_t*>(valid),
                     static_cast<const int32_t*>(pos), M, rows, pitch,
                     block_base,
                     reinterpret_cast<uintptr_t>(codes) % 16 == 0 && pitch % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) return launch_hdlc<Form::kGroupCodes>(a, in, st);
  if (form == 1) return launch_hdlc<Form::kSampleCodes>(a, in, st);
  if (form == 2) return launch_hdlc<Form::kSlots>(a, in, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
