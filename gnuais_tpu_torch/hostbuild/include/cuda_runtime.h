// Host stand-in for the CUDA runtime, for the host build of the port's
// kernels (gnuais_tpu_torch/hostbuild): a launch runs its blocks one
// after another, each as one std::thread per CUDA thread with its own
// threadIdx, a shared-memory buffer per block, __syncthreads and
// __syncwarp as std::barriers and an mbarrier as an atomic 64-bit word.
// Enough for the kernels of csrc/, nothing more.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <atomic>
#include <chrono>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

struct int4 {
  int x, y, z, w;
};

struct alignas(16) float4 {
  float x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace gnuais_host {

struct Context {
  dim3 thread, block, dim, grid;
  unsigned char* smem;
  std::barrier<>* block_bar;
  std::barrier<>* warp_bar;   // this thread's warp's
};

inline thread_local Context ctx;

inline unsigned char* shared() { return ctx.smem; }

// An mbarrier: bit 63 the phase's parity, bits 32..62 the arrivals a
// phase expects, bits 0..31 those still pending.
inline void bar_init(uint64_t* bar, int count) {
  std::atomic_ref<uint64_t>(*bar).store((uint64_t(count) << 32) | uint64_t(count));
}

inline void bar_arrive(uint64_t* bar) {
  std::atomic_ref<uint64_t> word(*bar);
  uint64_t old = word.load(), next;
  do {
    const uint64_t pending = old & 0xFFFFFFFFu;
    const uint64_t expected = (old >> 32) & 0x7FFFFFFFu;
    next = pending > 1 ? old - 1
                       : (((old >> 63) ^ 1) << 63) | (expected << 32) | expected;
  } while (!word.compare_exchange_weak(old, next));
}

// Returns once the phase of parity `parity` has completed.  A wait of a
// minute is a deadlock of the kernel's barriers: it aborts the process
// rather than hang it.
inline void bar_wait(uint64_t* bar, uint32_t parity) {
  std::atomic_ref<uint64_t> word(*bar);
  const auto give_up = std::chrono::steady_clock::now() + std::chrono::seconds(60);
  while ((word.load() >> 63) == parity) {
    if (std::chrono::steady_clock::now() > give_up) {
      fprintf(stderr, "gnuais host build: mbarrier wait deadlocked\n");
      abort();
    }
    std::this_thread::yield();
  }
}

// kernel<<<grid, block, smem, stream>>>(args), rewritten by the builder
// into launch([&] { kernel(args); }, grid, block, smem, stream).
template <class Body>
void launch(Body&& body, dim3 grid, dim3 block, size_t smem = 0,
            cudaStream_t = nullptr) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<unsigned char> buf(smem + 256);
        unsigned char* base = reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(buf.data()) + 255) & ~uintptr_t(255));
        std::barrier<> block_bar(n);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (unsigned w = 0; w < (n + 31) / 32; ++w)
          warps.emplace_back(new std::barrier<>(n - 32 * w < 32 ? n - 32 * w : 32));
        std::vector<std::thread> threads;
        for (unsigned i = 0; i < n; ++i)
          threads.emplace_back([&, i] {
            ctx.thread = dim3(i % block.x, i / block.x % block.y,
                              i / (block.x * block.y));
            ctx.block = dim3(bx, by, bz);
            ctx.dim = block;
            ctx.grid = grid;
            ctx.smem = base;
            ctx.block_bar = &block_bar;
            ctx.warp_bar = warps[i / 32].get();
            body();
          });
        for (auto& t : threads) t.join();
      }
}

}  // namespace gnuais_host

#define threadIdx (gnuais_host::ctx.thread)
#define blockIdx (gnuais_host::ctx.block)
#define blockDim (gnuais_host::ctx.dim)
#define gridDim (gnuais_host::ctx.grid)

inline void __syncthreads() { gnuais_host::ctx.block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  gnuais_host::ctx.warp_bar->arrive_and_wait();
}

template <class T>
T __ldg(const T* p) {
  return *p;
}
