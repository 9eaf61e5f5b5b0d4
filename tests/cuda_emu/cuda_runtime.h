// A CPU stand-in for the CUDA runtime features that csrc/post.cu uses, so
// that the host C++ compiler can build and run its device code in a test
// (tests/test_torch_post_kernel.py).  It checks the kernel's arithmetic,
// indexing and barrier structure, not CUDA's compiler or timing.
//
// A block runs as `threads` std::threads, one block after another;
// __syncthreads is a std::barrier of the block; a warp shuffle or ballot
// writes its value to the warp's slots and reads its source's (or all 32)
// after a barrier of the warp's 32 threads, so every lane of the warp must
// reach it, as the full mask says.  The slots alternate between two
// arrays, one barrier an exchange: a lane writes an array again only after
// the next exchange's barrier, which every lane reaches after its read.
// __syncwarp is the warp's barrier; atomicOr, atomicCAS and atomicExch are
// host atomics and __threadfence a sequentially consistent fence.
// __shared__ variables become function statics (one copy, shared by the
// block's threads), so blocks must not overlap: emu_launch runs them in
// turn.  The test rewrites the one piece of CUDA syntax the host compiler
// cannot read: `kernel<<<grid, block, smem, stream>>>(args)` becomes
// `emu_launch(kernel, grid, block, smem, args)`.
#pragma once
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__
#define __shared__ static

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// The shape query builds; its numbers are the card's alone (zeros here).
struct cudaFuncAttributes {
  size_t sharedSizeBytes = 0, localSizeBytes = 0;
  int numRegs = 0;
};
template <class F>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* fa, F) {
  *fa = cudaFuncAttributes{};
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

struct int2 {
  int x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx;
inline thread_local unsigned emu_round = 0;  // this thread's exchanges so far

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned> slots;  // [2][threads]
};
inline EmuBlock* emu_block = nullptr;

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warps[threadIdx.x >> 5]->arrive_and_wait();
}

// Writes v to this lane's slot, waits for the warp, returns its 32 slots.
inline const unsigned* emu_publish(unsigned v) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t half = emu_block->slots.size() / 2;
  unsigned* s = &emu_block->slots[(emu_round++ & 1) * half + w * 32];
  s[lane] = v;
  emu_block->warps[w]->arrive_and_wait();
  return s;
}

inline unsigned __shfl_sync(unsigned, unsigned v, int src) { return emu_publish(v)[src & 31]; }
inline unsigned __shfl_up_sync(unsigned, unsigned v, int off) {
  const int lane = threadIdx.x & 31;
  return emu_publish(v)[lane >= off ? lane - off : lane];
}
inline long long __shfl_up_sync(unsigned m, long long v, int off) {
  const unsigned lo = __shfl_up_sync(m, (unsigned)v, off);
  const unsigned hi = __shfl_up_sync(m, (unsigned)((unsigned long long)v >> 32), off);
  return (long long)(((unsigned long long)hi << 32) | lo);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned* s = emu_publish(pred != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= s[i] << i;
  return r;
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (shift & 31));
}
inline unsigned atomicOr(unsigned* a, unsigned v) {
  return __atomic_fetch_or(a, v, __ATOMIC_SEQ_CST);
}
inline int atomicCAS(int* a, int expected, int v) {
  __atomic_compare_exchange_n(a, &expected, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
  return expected;
}
inline int atomicExch(int* a, int v) { return __atomic_exchange_n(a, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

template <class K, class... A>
void emu_launch(K kernel, int n_blocks, int threads, int, A... args) {
  for (int b = 0; b < n_blocks; ++b) {
    EmuBlock eb;
    eb.block = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      eb.warps.push_back(std::make_unique<std::barrier<>>(32));
    eb.slots.assign(2 * (size_t)threads, 0);
    emu_block = &eb;
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_round = 0;
        kernel(args...);
      });
    for (auto& th : team) th.join();
  }
}
