// rANS decode of MICW strips for Hopper: the symbols-out kernels of the post
// path.  (The fused direct modes, zzd / vdd / pdd, are rans_direct.cu's.)
//
// Two kernels, one thread block of 128 threads per strip (thread = lane):
//
// * rans_zzd_kernel<0, false> replaces mic_tpu/tpu/pallas_rans.py:_kernel_packed
//   (wrapper rans_decode_pallas_packed): FF 57 packed-table decode storing
//   symbols, tpk[slot] = bias<<12 | rank and alpha[rank] = (freq-1)<<16 | sym.
// * rans_two_table_kernel replaces pallas_rans.py:_kernel (wrapper
//   rans_decode_pallas): the FF 57 decode through tsym[slot] and
//   tfb[slot] = freq<<16 | bias, for tableLog up to 16 or alphabets over
//   4096, storing symbols.
//
// Both renormalise (lanes whose state fell below 2^16 take the next words
// of the strip's stream, in lane order: an exclusive block scan of the
// need mask plus one word read) and feed the post path (the SoA-RLE
// expand, escape parse and predictor inverses as torch ops in
// mic_tpu_torch/tpu/post.py).  The step of each front end and the scan
// live in rans_common.cuh, shared with the r-mode kernels of rans_rle.cu.
//
// What bounds them on this card: the decode is a serial chain of
// dependent steps per strip (the TPU grid's sequential carry becomes the
// block's step loop), and each step is a table lookup, one global word
// read and a block scan with a barrier.  So the kernels are
// latency-bound, not bandwidth-bound: a 512-step strip moves only ~128 KB
// of symbols and ~60 KB of words.  The design keeps the tables in shared
// memory (tpk + alpha <= 32 KB, and the two-table form's 8 * 2^tl bytes
// up to the card's opt-in limit, 227 KB: tl <= 14), does each scan with
// warp shuffles and one barrier over a double-buffered 4-warp total, and
// relies on many strips (one block each) being resident per SM to hide
// the per-step latency.  The two tables of tl 15-16 (256-512 KB a strip)
// do not fit a block, so that form reads them from device memory through
// L2; a staged two-table block of 64-128 KB leaves room for one to three
// blocks per SM.
//
// Out-of-range guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (valid operands never reach them):
// a logical shift by >= 32 gives 0 (jax.lax.shift_right_logical's rule;
// a C++ shift by >= 32 is undefined), a slot or rank beyond its table
// reads 0 (the Pallas sweeps match no tile), and the renorm word window's
// first row clamps to rows - 2 (the Pallas kernels' dynamic-slice clamp).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  Each C entry point returns
// cudaGetLastError() after its launch.

#include "rans_common.cuh"

namespace {

template <int VWS, bool FUSED>
__global__ void __launch_bounds__(kLanes)
rans_zzd_kernel(const uint32_t* __restrict__ init, const uint32_t* __restrict__ tpk,
                int ts, const uint32_t* __restrict__ alpha, int asz,
                const uint32_t* __restrict__ words, int rows,
                const uint32_t* __restrict__ mask, const uint32_t* __restrict__ shift,
                const uint32_t* __restrict__ ws, uint16_t* __restrict__ out,
                int steps) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t scan_buf[16];
  uint32_t* s_tpk = smem;
  uint32_t* s_alpha = smem + ts;
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < ts; i += kLanes) s_tpk[i] = tpk[(size_t)s * ts + i];
  for (int i = lane; i < asz; i += kLanes) s_alpha[i] = alpha[(size_t)s * asz + i];
  __syncthreads();

  const size_t li = (size_t)s * kLanes + lane;
  const PackedFront front{s_tpk, ts, s_alpha, asz};
  Lane l{init[li], mask[li], shift[li], 0, words + (size_t)s * rows * kLanes, rows};
  uint16_t* o = out + (size_t)s * steps * kLanes + lane;
  Inverse<VWS> inverse(FUSED ? (int)ws[(size_t)s * kLanes] : 0);
  int phase = 0;
  constexpr int U = VWS > 0 ? VWS : 1;
  for (int t0 = 0; t0 < steps; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const uint32_t sym = front.step(l, scan_buf, phase);
      o[(size_t)(t0 + c) * kLanes] = FUSED ? inverse(sym, c, scan_buf, phase) : (uint16_t)sym;
    }
  }
}

// STAGED: the two tables are copied into dynamic shared memory (2 * ts
// words); otherwise the step reads them from device memory.
template <bool STAGED>
__global__ void __launch_bounds__(kLanes)
rans_two_table_kernel(const uint32_t* __restrict__ init, const uint32_t* __restrict__ tsym,
                      const uint32_t* __restrict__ tfb, int ts,
                      const uint32_t* __restrict__ words, int rows,
                      const uint32_t* __restrict__ mask, const uint32_t* __restrict__ shift,
                      uint16_t* __restrict__ out, int steps) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t scan_buf[16];
  const int s = blockIdx.x, lane = threadIdx.x;
  const uint32_t* g_sym = tsym + (size_t)s * ts;
  const uint32_t* g_fb = tfb + (size_t)s * ts;
  TwoTableFront front{g_sym, g_fb, ts};
  if (STAGED) {
    for (int i = lane; i < ts; i += kLanes) {
      smem[i] = g_sym[i];
      smem[ts + i] = g_fb[i];
    }
    __syncthreads();
    front.tsym = smem;
    front.tfb = smem + ts;
  }
  const size_t li = (size_t)s * kLanes + lane;
  Lane l{init[li], mask[li], shift[li], 0, words + (size_t)s * rows * kLanes, rows};
  uint16_t* o = out + (size_t)s * steps * kLanes + lane;
  int phase = 0;
  for (int t = 0; t < steps; ++t) o[(size_t)t * kLanes] = (uint16_t)front.step(l, scan_buf, phase);
}

template <int VWS, bool FUSED>
void launch_zzd(int n, size_t smem, cudaStream_t st, const uint32_t* init,
                const uint32_t* tpk, int ts, const uint32_t* alpha, int asz,
                const uint32_t* words, int rows, const uint32_t* mask,
                const uint32_t* shift, const uint32_t* ws, uint16_t* out, int steps) {
  rans_zzd_kernel<VWS, FUSED><<<n, kLanes, smem, st>>>(init, tpk, ts, alpha, asz, words,
                                                       rows, mask, shift, ws, out, steps);
}

}  // namespace

extern "C" {

int mic_rans_decode_packed(const void* init, const void* tpk, int ts, const void* alpha,
                           int asz, const void* words, int rows, const void* mask,
                           const void* shift, void* out, int n_strips, int steps,
                           void* stream) {
  const size_t smem = (size_t)(ts + asz) * sizeof(uint32_t);
  launch_zzd<0, false>(n_strips, smem, (cudaStream_t)stream, (const uint32_t*)init,
                       (const uint32_t*)tpk, ts, (const uint32_t*)alpha, asz,
                       (const uint32_t*)words, rows, (const uint32_t*)mask,
                       (const uint32_t*)shift, nullptr, (uint16_t*)out, steps);
  return (int)cudaGetLastError();
}

// Stages the tables in shared memory when 2 * ts words fit the device's
// opt-in limit per block, else reads them from device memory.
int mic_rans_decode_two_table(const void* init, const void* tsym, const void* tfb, int ts,
                              const void* words, int rows, const void* mask,
                              const void* shift, void* out, int n_strips, int steps,
                              void* stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)ts * sizeof(uint32_t);
  const size_t fixed = 16 * sizeof(uint32_t);  // scan_buf
  cudaStream_t st = (cudaStream_t)stream;
  auto* i = (const uint32_t*)init;
  auto* sy = (const uint32_t*)tsym;
  auto* fb = (const uint32_t*)tfb;
  auto* wd = (const uint32_t*)words;
  auto* mk = (const uint32_t*)mask;
  auto* sh = (const uint32_t*)shift;
  auto* o = (uint16_t*)out;
  if (smem + fixed <= (size_t)optin) {
    e = cudaFuncSetAttribute(rans_two_table_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    rans_two_table_kernel<true><<<n_strips, kLanes, smem, st>>>(i, sy, fb, ts, wd, rows, mk,
                                                               sh, o, steps);
  } else {
    rans_two_table_kernel<false><<<n_strips, kLanes, 0, st>>>(i, sy, fb, ts, wd, rows, mk,
                                                             sh, o, steps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
