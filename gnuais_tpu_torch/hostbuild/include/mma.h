// Host stand-in for CUDA's WMMA (mma.h), for the host build of the
// port's kernels: a fragment holds its whole tile in every lane, a load
// reads the whole tile, a product computes it in every lane (float32
// sums in k order), and only lane 0 stores.  TF32 rounding is to
// nearest, ties away from zero, as cvt.rna.tf32.f32.

#pragma once

#include <stdint.h>
#include <string.h>

#include "cuda_runtime.h"

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
namespace precision {
struct tf32 {};
}  // namespace precision
enum layout_t { mem_row_major, mem_col_major };

template <class Use, int M, int N, int K>
struct tile_shape;
template <int M, int N, int K>
struct tile_shape<matrix_a, M, N, K> { static constexpr int rows = M, cols = K; };
template <int M, int N, int K>
struct tile_shape<matrix_b, M, N, K> { static constexpr int rows = K, cols = N; };
template <int M, int N, int K>
struct tile_shape<accumulator, M, N, K> { static constexpr int rows = M, cols = N; };

template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
  static constexpr int rows = tile_shape<Use, M, N, K>::rows;
  static constexpr int cols = tile_shape<Use, M, N, K>::cols;
  static constexpr int num_elements = rows * cols;
  float x[rows * cols];
};

inline float __float_to_tf32(float v) {
  uint32_t b;
  memcpy(&b, &v, 4);
  if ((b & 0x7F800000u) != 0x7F800000u) b = (b + 0x1000u) & 0xFFFFE000u;
  memcpy(&v, &b, 4);
  return v;
}

template <class F>
void fill_fragment(F& f, float v) {
  for (int i = 0; i < F::num_elements; ++i) f.x[i] = v;
}

template <class F>
void load_matrix_sync(F& f, const float* p, unsigned ldm) {
  for (int r = 0; r < F::rows; ++r)
    for (int c = 0; c < F::cols; ++c) f.x[r * F::cols + c] = p[r * ldm + c];
}

template <class F>
void store_matrix_sync(float* p, const F& f, unsigned ldm, layout_t) {
  if (threadIdx.x % 32 != 0) return;
  for (int r = 0; r < F::rows; ++r)
    for (int c = 0; c < F::cols; ++c) p[r * ldm + c] = f.x[r * F::cols + c];
}

template <class D, class A, class B, class C>
void mma_sync(D& d, const A& a, const B& b, const C& c) {
  float out[D::num_elements];
  for (int i = 0; i < D::rows; ++i)
    for (int j = 0; j < D::cols; ++j) {
      float s = c.x[i * D::cols + j];
      for (int k = 0; k < A::cols; ++k)
        s = s + a.x[i * A::cols + k] * b.x[k * B::cols + j];
      out[i * D::cols + j] = s;
    }
  memcpy(d.x, out, sizeof(out));
}

}  // namespace wmma
}  // namespace nvcuda
