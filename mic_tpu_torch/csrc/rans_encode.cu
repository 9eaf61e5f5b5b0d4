// Wide-lane rANS encode of the MICT format (FF 57 and FF 41) for Hopper.
//
// rans_enc_kernel<ALIAS> replaces mic_tpu/tpu/pallas_enc.py:_kernel_enc
// in both its forms: wrapper rans_encode_pallas (ALIAS = false, FF 57)
// and rans_encode_pallas_alias (ALIAS = true, FF 41, the written slot
// mapped through a 256-entry run table).
//
// Each lane of each strip is an independent rANS chain walked from its
// last symbol back to its first.  Unlike the decoders there is no lane
// prefix sum: every renorm word goes out dense at its own (step, lane)
// slot with a flag beside it, and the host compacts words[flags] in
// (step asc, lane asc) order, which is the decoder's word order.  So one
// thread is one (strip, lane) and one block of 128 threads is one strip,
// with no barrier inside the step loop.  The strip's per-rank tables
// (te1/te2, at most 2 x 4096 x 4 B = 32 KB) and, for FF 41, its run
// tables (2 x 256 x 4 B) are staged in shared memory; rank loads and
// word/flag stores are coalesced across the 128 lanes of a step.
//
// Per step (pallas_enc.py:139-196): active = t*128 + lane < count;
// need = x >= f << (32 - tl) on active lanes; a renorming lane emits
// x & 0xFFFF and shifts x right by 16; then q = x / f by the magic
// multiply (__umulhi gives the same high word as the Pallas kernel's four
// 16-bit partial products) with the add/shift fix-up (f == 1: q = x),
// rem = x - q*f, and x = (q << tl) + cum + rem (FF 57) or
// (q << tl) + base[r] + (cum + rem - start[r]) with r the last run whose
// start <= cum + rem (FF 41).  Inactive lanes keep their state.
//
// Cost: each symbol moves 6 bytes (a u16 rank in, a u16 word and a u16
// flag out) against a chain of ~40 dependent integer operations and one
// shared-memory table read per step and lane.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W: 0.313 ms for 1536 strips x 512 steps (FF 57) and
// 0.730 ms (FF 41).  Not measured: what bounds either form.  Those 6
// bytes per symbol over 0.313 ms come to about 1.9 TB/s, an estimate that
// leaves out the table loads; that the FF 41 form's nine dependent
// shared-memory reads per step for the run search make it slower is a
// hypothesis no profile has checked yet.
//
// Guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_encode.py (valid operands never reach them): a
// rank at or beyond the table width reads zero entries (freq 1, magic 0,
// so no division and no read past shared memory), and a shift by >= 32
// gives 0 (jax.lax.shift_left's rule; a C++ shift by >= 32 is undefined).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRuns = 256;

__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  return s < 32u ? (x << s) : 0u;
}

template <bool ALIAS>
__global__ void __launch_bounds__(kLanes)
rans_enc_kernel(const uint16_t* __restrict__ ranks, const uint32_t* __restrict__ te1,
                const uint32_t* __restrict__ te2, int aw,
                const uint32_t* __restrict__ ar1, const uint32_t* __restrict__ ar2,
                const uint32_t* __restrict__ count, const uint32_t* __restrict__ tls,
                uint16_t* __restrict__ out_w, uint16_t* __restrict__ out_f,
                uint32_t* __restrict__ out_x, int steps) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t s_start[ALIAS ? kRuns : 1], s_base[ALIAS ? kRuns : 1];
  uint32_t* s_te1 = smem;
  uint32_t* s_te2 = smem + aw;
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < aw; i += kLanes) {
    s_te1[i] = te1[(size_t)s * aw + i];
    s_te2[i] = te2[(size_t)s * aw + i];
  }
  if constexpr (ALIAS) {
    for (int i = lane; i < kRuns; i += kLanes) {
      s_start[i] = ar1[(size_t)s * kRuns + i];
      s_base[i] = ar2[(size_t)s * kRuns + i];
    }
  }
  __syncthreads();

  const size_t li = (size_t)s * kLanes + lane;
  const int cnt = (int)count[li];  // signed compare, as the Pallas kernel's int32 cast
  const uint32_t tl = tls[li];
  const uint32_t shift_rn = 32u - tl;
  const size_t base = (size_t)s * steps * kLanes + lane;
  uint32_t x = 1u << 16;
  for (int t = steps - 1; t >= 0; --t) {
    const size_t o = base + (size_t)t * kLanes;
    const bool active = t * kLanes + lane < cnt;
    const uint32_t rk = ranks[o];
    const bool ok = rk < (uint32_t)aw;
    const uint32_t e1 = ok ? s_te1[rk] : 0u;
    const uint32_t m = ok ? s_te2[rk] : 0u;
    const uint32_t f = (e1 >> 18) + 1u;
    const uint32_t c = (e1 >> 4) & 0xFFFu;
    const uint32_t sh = e1 & 0xFu;
    const bool need = active && x >= shl(f, shift_rn);
    out_w[o] = need ? (uint16_t)(x & 0xFFFFu) : (uint16_t)0u;
    out_f[o] = (uint16_t)need;
    const uint32_t x1 = need ? (x >> 16) : x;
    const uint32_t th = __umulhi(x1, m);
    uint32_t q = ((e1 >> 17) & 1u) ? ((th + ((x1 - th) >> 1)) >> sh) : (th >> sh);
    if ((e1 >> 16) & 1u) q = x1;
    const uint32_t rem = x1 - q * f;
    uint32_t x2;
    if constexpr (ALIAS) {
      // Count of run starts <= s_idx: 9 rounds over 256 sorted entries
      // (pad 0xFFFFFFFF); the run is the last of them.
      const uint32_t s_idx = rem + c;
      int n_le = 0;
#pragma unroll
      for (int st = kRuns; st; st >>= 1) {
        const int cand = n_le + st;
        if (cand <= kRuns && s_start[min(cand - 1, kRuns - 1)] <= s_idx) n_le = cand;
      }
      const int r = max(n_le - 1, 0);
      x2 = shl(q, tl) + s_base[r] + (s_idx - s_start[r]);
    } else {
      x2 = shl(q, tl) + rem + c;
    }
    x = active ? x2 : x1;
  }
  out_x[li] = x;
}

}  // namespace

extern "C" {

// alias != 0 selects the FF 41 form (ar1/ar2 are then read).  Returns
// cudaErrorInvalidValue for a table width the kernel does not take, else
// cudaGetLastError() after the launch.
int mic_rans_encode(const void* ranks, const void* te1, const void* te2, int aw,
                    const void* ar1, const void* ar2, const void* count,
                    const void* tls, void* out_w, void* out_f, void* out_x,
                    int n_strips, int steps, int alias, void* stream) {
  if (aw <= 0 || aw > 4096 || n_strips <= 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * aw * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  auto* rk = (const uint16_t*)ranks;
  auto* t1 = (const uint32_t*)te1;
  auto* t2 = (const uint32_t*)te2;
  auto* a1 = (const uint32_t*)ar1;
  auto* a2 = (const uint32_t*)ar2;
  auto* cn = (const uint32_t*)count;
  auto* tl = (const uint32_t*)tls;
  auto* w = (uint16_t*)out_w;
  auto* f = (uint16_t*)out_f;
  auto* x = (uint32_t*)out_x;
  if (alias)
    rans_enc_kernel<true><<<n_strips, kLanes, smem, st>>>(rk, t1, t2, aw, a1, a2, cn, tl,
                                                          w, f, x, steps);
  else
    rans_enc_kernel<false><<<n_strips, kLanes, smem, st>>>(rk, t1, t2, aw, a1, a2, cn,
                                                           tl, w, f, x, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
