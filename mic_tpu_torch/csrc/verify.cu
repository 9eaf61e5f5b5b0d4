// The timed runner's compare for Hopper: the mismatching pixels of every
// bucket of a MicwDecodePlan run against the expected pixels, and the
// probe, in one launch.
//
// mismatch_groups_kernel replaces the compare inside mic_tpu's timed
// runner, mic_tpu/tpu/strips.py:2296-2306 (MicwDecodePlan.make_timed_runner:
// sum((out[:, :cols] != exp) & (lane < valid)) per bucket, valid an int32
// per row, fused by XLA into the runner's one program), and the probe
// beside it (:2294-2295, each bucket's out[0, :8]).  Per bucket g of a
// launch (mic_tpu_torch/tpu/verify.py: count_mismatches):
//   mismatches += #{(r, c) : c < valid[m], out[r, c] != exp[m, c]}, m = rowmap[r]
//   probe      += sum of out[0, c] for c < min(8, width), as u16 values
// out is int16 [S, width] with row stride `stride` (the bucket's output of
// this run), exp int16 [U, cols], valid int32 [U] and rowmap int32 [S]
// (staged once by the runner: the bucket's distinct expected rows, U < S
// where the batch replicates a blob, and each output row's among them).
// Values compare as 16-bit patterns (__vcmpne2 on two pixels a word, or
// u16 loads): neither side is widened to a signed type.  Both totals are
// exact: u32 per thread, u64 per block, one atomicAdd per block into a
// device int64 pair (acc[0] mismatches, acc[1] probe).
//
// Design.  The compare reads each output pixel and its expected pixel
// once and writes nothing: it is bound by those bytes over the card's
// memory rate.  The runner's former torch ops (a strided compare writing
// a bool tensor of the output's size, an AND with a bool mask of the
// same size, a sum, per bucket) moved about four times those bytes in ~4
// launches a bucket.  Here blocks are (group, row, c0, c1) chunks of at
// most verify.py's CHUNK pixels below the row's valid length, made once
// by the host (verify.py: MismatchPacking); a thread reads 8 pixels of
// each side a step as 16-byte vectors where both rows are 16-byte
// aligned (the tail, and unaligned rows, a pixel a thread), the output
// with a streaming load (read once) and the expected rows through the
// read-only path, so that a replicated blob's expected rows, read by
// each replica, stay in the 50 MB L2: a run reads about the output's
// bytes.  The last block of the grid adds the probe.  A launch with no
// compare blocks is the probe alone (runs 1..n-1 of a runner).  The
// outputs of a run are new tensors, so their pointers, strides and
// widths travel in the launch's parameters (a __grid_constant__ struct,
// read in place).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 128;  // buckets a launch (verify.py: MAX_GROUPS)
constexpr int kProbe = 8;        // the probe's pixels a bucket (out[0, :8])

// One bucket's staged expected rows (verify.py: _GROUP_DESC, 32 bytes).
struct Group {
  const uint16_t* exp;    // [U, cols]
  const int32_t* valid;   // [U]
  const int32_t* rowmap;  // [S]: each output row's expected row
  int32_t cols, pad;
};

// One run's outputs.
struct Outs {
  const uint16_t* p[kMaxGroups];
  long long stride[kMaxGroups];  // elements from one row to the next
  int width[kMaxGroups];         // elements a row
};

__device__ __forceinline__ unsigned ne_halves16(const uint4& a, const uint4& b) {
  // 16 for each differing 16-bit half
  return __popc(__vcmpne2(a.x, b.x)) + __popc(__vcmpne2(a.y, b.y)) +
         __popc(__vcmpne2(a.z, b.z)) + __popc(__vcmpne2(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
mismatch_groups_kernel(const Group* __restrict__ groups, const int4* __restrict__ blocks,
                       int n_cmp, int n_groups, const __grid_constant__ Outs outs,
                       unsigned long long* __restrict__ acc) {
  __shared__ unsigned long long part[kThreads / 32];
  unsigned long long mine = 0;
  int slot = 0;
  if ((int)blockIdx.x < n_cmp) {
    const int4 b = blocks[blockIdx.x];  // group, row, c0, c1
    const Group g = groups[b.x];
    const int prow = g.rowmap[b.y];
    const int end = min(b.w, g.valid[prow]);
    const uint16_t* o = outs.p[b.x] + (size_t)b.y * (size_t)outs.stride[b.x];
    const uint16_t* e = g.exp + (size_t)prow * (size_t)g.cols;
    unsigned n16 = 0, n = 0;
    int c = b.z;  // a multiple of 8: o + c and e + c keep the rows' alignment
    if (((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(e)) & 15) == 0) {
      const int vend = c + ((end - c) & ~7);
#pragma unroll 4
      for (int i = c + 8 * (int)threadIdx.x; i < vend; i += 8 * kThreads)
        n16 += ne_halves16(__ldcs(reinterpret_cast<const uint4*>(o + i)),
                           __ldg(reinterpret_cast<const uint4*>(e + i)));
      c = vend;
    }
    for (int i = c + (int)threadIdx.x; i < end; i += kThreads) n += o[i] != e[i];
    mine = (n16 >> 4) + n;
  } else {
    slot = 1;
    for (int t = threadIdx.x; t < n_groups * kProbe; t += kThreads) {
      const int gi = t / kProbe, j = t % kProbe;
      if (j < outs.width[gi]) mine += outs.p[gi][j];
    }
  }
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += part[w];
    if (sum) atomicAdd(acc + slot, sum);
  }
}

}  // namespace

extern "C" {

// One launch: n_cmp compare blocks (groups and blocks are device arrays,
// above) and the probe block.  outs, strides and widths are host arrays
// of n_groups entries; acc is a device int64 pair.  Returns
// cudaErrorInvalidValue for sizes the kernel does not take, else the
// launch's error (cudaGetLastError()).
int mic_mismatch_groups(const void* groups, const void* blocks, int n_cmp,
                        const void* const* outs, const long long* strides, const int* widths,
                        int n_groups, void* acc, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || n_cmp < 0 || (n_cmp > 0 && !blocks))
    return (int)cudaErrorInvalidValue;
  Outs o = {};
  for (int i = 0; i < n_groups; ++i) {
    o.p[i] = (const uint16_t*)outs[i];
    o.stride[i] = strides[i];
    o.width[i] = widths[i];
  }
  mismatch_groups_kernel<<<n_cmp + 1, kThreads, 0, (cudaStream_t)stream>>>(
      (const Group*)groups, (const int4*)blocks, n_cmp, n_groups, o,
      (unsigned long long*)acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
