// A CPU stand-in for the CUDA runtime features that csrc/post.cu uses, so
// that the host C++ compiler can build and run its device code in a test
// (tests/test_torch_post_kernel.py).  It checks the kernel's arithmetic,
// indexing and barrier structure, not CUDA's compiler or timing.
//
// A block runs as `threads` std::threads, one block after another;
// __syncthreads is a std::barrier of the block; a warp shuffle writes its
// value to the warp's slot array and reads its source's between two
// barriers of the warp's 32 threads.  __shared__ variables become function
// statics (one copy, shared by the block's threads), so blocks must not
// overlap: emu_launch runs them in turn.  The test rewrites the two pieces
// of CUDA syntax the host compiler cannot read: `extern __shared__ T
// name[];` becomes `T* name = emu_dynamic_shared<T>();` and `kernel<<<grid,
// block, smem, stream>>>(args)` becomes `emu_launch(kernel, grid, block,
// smem, args)`.
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
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__ static

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct int2 {
  int x, y;
};
struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx;

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned> slots;
};
inline EmuBlock* emu_block = nullptr;
inline std::vector<unsigned char> emu_dynamic;  // the launch's dynamic shared memory

template <class T>
inline T* emu_dynamic_shared() { return reinterpret_cast<T*>(emu_dynamic.data()); }

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }

inline unsigned emu_exchange(unsigned v, int src) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* s = &emu_block->slots[w * 32];
  s[lane] = v;
  emu_block->warps[w]->arrive_and_wait();
  const unsigned r = s[src];
  emu_block->warps[w]->arrive_and_wait();
  return r;
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, int off) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane >= off ? lane - off : lane);
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) { return emu_exchange(v, src); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }

template <class K, class... A>
void emu_launch(K kernel, int n_blocks, int threads, int smem_bytes, A... args) {
  emu_dynamic.assign((size_t)smem_bytes + 16, 0xA5);  // garbage, as on the card
  for (int b = 0; b < n_blocks; ++b) {
    EmuBlock eb;
    eb.block = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      eb.warps.push_back(std::make_unique<std::barrier<>>(32));
    eb.slots.assign(threads, 0);
    emu_block = &eb;
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : team) th.join();
  }
}
