// rANS decode of MICW strips for Hopper: the fused direct modes (zzd / vdd
// / pdd) and the symbols-out kernels of the post path.
//
// Three kernels, one thread block of 128 threads per strip (thread = lane):
//
// * rans_zzd_kernel<VWS, true> replaces mic_tpu/tpu/pallas_rans.py:_kernel_zzd
//   (wrapper rans_decode_pallas_zzd): FF 57 packed-table decode,
//   tpk[slot] = bias<<12 | rank and alpha[rank] = (freq-1)<<16 | sym.
//   rans_zzd_kernel<0, false> replaces pallas_rans.py:_kernel_packed
//   (wrapper rans_decode_pallas_packed): the same decode storing symbols.
// * rans_two_table_kernel replaces pallas_rans.py:_kernel (wrapper
//   rans_decode_pallas): the FF 57 decode through tsym[slot] and
//   tfb[slot] = freq<<16 | bias, for tableLog up to 16 or alphabets over
//   4096, storing symbols.
// * rans_alias_kernel replaces pallas_rans.py:_kernel_alias (wrapper
//   rans_decode_pallas_alias): FF 41 alias-bucket decode, three lookups
//   in 128-entry bucket tables plus escape substitution from the side
//   stream; FUSED=false stores the symbols.
//
// All renormalise (lanes whose state fell below 2^16 take the next words
// of the strip's stream, in lane order: an exclusive block scan of the
// need mask plus one word read).  The fused forms then apply the predictor
// inverse: unzigzag, then the row prefix sum with its per-strip row reset
// every ws steps (zzd, and pdd's first pass) or the previous-row carry of
// vdd_ws 128-lane chunks (vdd).  The symbols-out forms feed the post path
// (the SoA-RLE expand, escape parse and predictor inverses as torch ops in
// mic_tpu_torch/tpu/post.py).  The step of each front end, the scan and
// the inverse live in rans_common.cuh, shared with the r-mode kernels of
// rans_rle.cu.
//
// What bounds them on this card: the decode is a serial chain of
// dependent steps per strip (the TPU grid's sequential carry becomes the
// block's step loop), and each step is a table lookup, one global word
// read and one or two block scans with a barrier each.  So the kernels
// are latency-bound, not bandwidth-bound: a 512-step strip moves only
// ~128 KB of pixels and ~60 KB of words.  The design keeps the tables in
// shared memory (tpk + alpha <= 32 KB, 1.5 KB of bucket tables, and the
// two-table form's 8 * 2^tl bytes up to the card's opt-in limit, 227 KB:
// tl <= 14), does each scan with warp shuffles and one barrier over a
// double-buffered 4-warp total, and relies on many strips (one block
// each) being resident per SM to hide the per-step latency.  The two
// tables of tl 15-16 (256-512 KB a strip) do not fit a block, so that
// form reads them from device memory through L2; a staged two-table
// block of 64-128 KB leaves room for one to three blocks per SM.  Several
// strips per block, warp-per-strip layouts and the like are later work.
//
// Out-of-range guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (valid operands never reach them):
// a logical shift by >= 32 gives 0 (jax.lax.shift_right_logical's rule;
// a C++ shift by >= 32 is undefined), a slot or rank beyond its table
// reads 0 (the Pallas sweeps match no tile), an alias bucket index clamps
// to 127, the renorm word window's first row clamps to rows - 2, and the
// escape cursor clamps to erows * 128 - 256 (the Pallas kernels'
// dynamic-slice and emax clamps).
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

template <int VWS, bool FUSED, bool ESC>
__global__ void __launch_bounds__(kLanes)
rans_alias_kernel(const uint32_t* __restrict__ init, const uint32_t* __restrict__ w0,
                  const uint32_t* __restrict__ w1, const uint32_t* __restrict__ w2,
                  const uint32_t* __restrict__ words, int rows,
                  const uint32_t* __restrict__ mask, const uint32_t* __restrict__ shift,
                  const uint32_t* __restrict__ escv, const uint32_t* __restrict__ esides,
                  int erows, const uint32_t* __restrict__ ws,
                  uint16_t* __restrict__ out, int steps) {
  __shared__ uint32_t s_w0[kLanes], s_w1[kLanes], s_w2[kLanes];
  __shared__ uint32_t scan_buf[16];
  const int s = blockIdx.x, lane = threadIdx.x;
  const size_t li = (size_t)s * kLanes + lane;
  s_w0[lane] = w0[li];
  s_w1[lane] = w1[li];
  s_w2[lane] = w2[li];
  __syncthreads();

  AliasFront<ESC> front{s_w0, s_w1, s_w2, escv[li], esides + (size_t)s * erows * kLanes,
                        erows * kLanes - 256, 0};
  Lane l{init[li], mask[li], shift[li], 0, words + (size_t)s * rows * kLanes, rows};
  uint16_t* o = out + (size_t)s * steps * kLanes + lane;
  Inverse<VWS> inverse((int)ws[(size_t)s * kLanes]);
  int phase = 0;
  constexpr int U = VWS > 0 ? VWS : 1;
  for (int t0 = 0; t0 < steps; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const uint32_t sym = front.step(l, scan_buf, phase);
      o[(size_t)(t0 + c) * kLanes] =
          FUSED ? inverse(sym, c, scan_buf, phase) : (uint16_t)sym;
    }
  }
}

template <int VWS, bool FUSED>
void launch_zzd(int n, size_t smem, cudaStream_t st, const uint32_t* init,
                const uint32_t* tpk, int ts, const uint32_t* alpha, int asz,
                const uint32_t* words, int rows, const uint32_t* mask,
                const uint32_t* shift, const uint32_t* ws, uint16_t* out, int steps) {
  rans_zzd_kernel<VWS, FUSED><<<n, kLanes, smem, st>>>(init, tpk, ts, alpha, asz, words,
                                                       rows, mask, shift, ws, out, steps);
}

template <int VWS, bool FUSED, bool ESC>
void launch_alias(int n, cudaStream_t st, const uint32_t* init, const uint32_t* w0,
                  const uint32_t* w1, const uint32_t* w2, const uint32_t* words,
                  int rows, const uint32_t* mask, const uint32_t* shift,
                  const uint32_t* escv, const uint32_t* esides, int erows,
                  const uint32_t* ws, uint16_t* out, int steps) {
  rans_alias_kernel<VWS, FUSED, ESC><<<n, kLanes, 0, st>>>(
      init, w0, w1, w2, words, rows, mask, shift, escv, esides, erows, ws, out, steps);
}

template <bool ESC>
void launch_alias_esc(int n, cudaStream_t st, int vdd_ws, bool fused,
                      const uint32_t* init, const uint32_t* w0, const uint32_t* w1,
                      const uint32_t* w2, const uint32_t* words, int rows,
                      const uint32_t* mask, const uint32_t* shift,
                      const uint32_t* escv, const uint32_t* esides, int erows,
                      const uint32_t* ws, uint16_t* out, int steps) {
#define MIC_ALIAS(V, F)                                                          \
  launch_alias<V, F, ESC>(n, st, init, w0, w1, w2, words, rows, mask, shift, escv, \
                          esides, erows, ws, out, steps)
  if (!fused) {
    MIC_ALIAS(0, false);
    return;
  }
  switch (vdd_ws) {
    case 0: MIC_ALIAS(0, true); break;
    case 1: MIC_ALIAS(1, true); break;
    case 2: MIC_ALIAS(2, true); break;
    case 4: MIC_ALIAS(4, true); break;
    case 8: MIC_ALIAS(8, true); break;
  }
#undef MIC_ALIAS
}

}  // namespace

extern "C" {

// Returns cudaErrorInvalidValue for a vdd_ws the kernels do not take,
// else cudaGetLastError() after the launch.
int mic_rans_decode_zzd(const void* init, const void* tpk, int ts, const void* alpha,
                        int asz, const void* words, int rows, const void* mask,
                        const void* shift, const void* ws, void* out, int n_strips,
                        int steps, int vdd_ws, void* stream) {
  const size_t smem = (size_t)(ts + asz) * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define MIC_ZZD(V)                                                                  \
  launch_zzd<V, true>(n_strips, smem, st, (const uint32_t*)init, (const uint32_t*)tpk, ts, \
                (const uint32_t*)alpha, asz, (const uint32_t*)words, rows,           \
                (const uint32_t*)mask, (const uint32_t*)shift, (const uint32_t*)ws,  \
                (uint16_t*)out, steps)
  switch (vdd_ws) {
    case 0: MIC_ZZD(0); break;
    case 1: MIC_ZZD(1); break;
    case 2: MIC_ZZD(2); break;
    case 4: MIC_ZZD(4); break;
    case 8: MIC_ZZD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIC_ZZD
  return (int)cudaGetLastError();
}

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

int mic_rans_decode_alias(const void* init, const void* w0, const void* w1,
                          const void* w2, const void* words, int rows, const void* mask,
                          const void* shift, const void* escv, const void* esides,
                          int erows, const void* ws, void* out, int n_strips, int steps,
                          int vdd_ws, int fused, int esc, void* stream) {
  if (vdd_ws != 0 && vdd_ws != 1 && vdd_ws != 2 && vdd_ws != 4 && vdd_ws != 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* i = (const uint32_t*)init;
  auto* a0 = (const uint32_t*)w0;
  auto* a1 = (const uint32_t*)w1;
  auto* a2 = (const uint32_t*)w2;
  auto* wd = (const uint32_t*)words;
  auto* mk = (const uint32_t*)mask;
  auto* sh = (const uint32_t*)shift;
  auto* ev = (const uint32_t*)escv;
  auto* es = (const uint32_t*)esides;
  auto* wsp = (const uint32_t*)ws;
  auto* o = (uint16_t*)out;
  if (esc)
    launch_alias_esc<true>(n_strips, st, vdd_ws, fused != 0, i, a0, a1, a2, wd, rows, mk,
                           sh, ev, es, erows, wsp, o, steps);
  else
    launch_alias_esc<false>(n_strips, st, vdd_ws, fused != 0, i, a0, a1, a2, wd, rows,
                            mk, sh, ev, es, erows, wsp, o, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
