// Fused rANS decode of the MICW direct modes (zzd / vdd / pdd) for Hopper.
//
// Two kernels, one thread block of 128 threads per strip (thread = lane):
//
// * rans_zzd_kernel replaces mic_tpu/tpu/pallas_rans.py:_kernel_zzd
//   (wrapper rans_decode_pallas_zzd): FF 57 packed-table decode,
//   tpk[slot] = bias<<12 | rank and alpha[rank] = (freq-1)<<16 | sym.
// * rans_alias_kernel replaces pallas_rans.py:_kernel_alias (wrapper
//   rans_decode_pallas_alias): FF 41 alias-bucket decode, three lookups
//   in 128-entry bucket tables plus escape substitution from the side
//   stream.
//
// Both then renormalise (lanes whose state fell below 2^16 take the next
// words of the strip's stream, in lane order: an exclusive block scan of
// the need mask plus one word read) and apply the predictor inverse:
// unzigzag, then the row prefix sum with its per-strip row reset every
// ws steps (zzd, and pdd's first pass) or the previous-row carry of
// vdd_ws 128-lane chunks (vdd).
//
// What bounds them on this card: the decode is a serial chain of
// dependent steps per strip (the TPU grid's sequential carry becomes the
// block's step loop), and each step is a shared-memory table lookup,
// one global word read and one or two block scans with a barrier each.
// So the kernels are latency-bound, not bandwidth-bound: a 512-step strip
// moves only ~128 KB of pixels and ~60 KB of words.  The design keeps the
// tables in shared memory (tpk + alpha <= 32 KB, or 1.5 KB of bucket
// tables), does each scan with warp shuffles and one barrier over a
// double-buffered 4-warp total, and relies on many strips (one block
// each) being resident per SM to hide the per-step latency.  Several
// strips per block, warp-per-strip layouts and the like are later work.
//
// Out-of-range guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (valid operands never reach them):
// a logical shift by >= 32 gives 0 (jax.lax.shift_right_logical's rule;
// a C++ shift by >= 32 is undefined), a packed slot or rank beyond its
// table reads 0, an alias bucket index clamps to 127, the renorm word
// window's first row clamps to rows - 2, and the escape cursor clamps to
// erows * 128 - 256 (the Pallas kernels' dynamic-slice and emax clamps).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  Each C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) {
  return s < 32u ? (x >> s) : 0u;
}

// Inclusive sum of two values over the block's 128 threads, plus both
// block totals.  buf holds 2 x 8 ints; phase alternates between its
// halves, so one barrier per call is enough: a thread can only write a
// half again after every thread has passed the barrier of the call in
// between, i.e. after every read of that half.
__device__ __forceinline__ void block_scan2(uint32_t& a, uint32_t& b,
                                            uint32_t& tot_a, uint32_t& tot_b,
                                            uint32_t* buf, int& phase) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t ta = __shfl_up_sync(kFull, a, o);
    const uint32_t tb = __shfl_up_sync(kFull, b, o);
    if (lane >= o) {
      a += ta;
      b += tb;
    }
  }
  uint32_t* s = buf + phase * 8;
  if (lane == 31) {
    s[warp] = a;
    s[4 + warp] = b;
  }
  __syncthreads();
  uint32_t oa = 0, ob = 0;
  tot_a = 0;
  tot_b = 0;
#pragma unroll
  for (int w = 0; w < kLanes / 32; ++w) {
    const uint32_t va = s[w], vb = s[4 + w];
    if (w < warp) {
      oa += va;
      ob += vb;
    }
    tot_a += va;
    tot_b += vb;
  }
  a += oa;
  b += ob;
  phase ^= 1;
}

// Renorm of one lane: k is the lane's exclusive rank among the lanes
// that need a word, total the strip's count of them this step.
__device__ __forceinline__ uint32_t renorm(uint32_t xn, bool need, uint32_t k,
                                           uint32_t total, int& cur,
                                           const uint32_t* words, int rows) {
  if (need) {
    const int row = min(cur >> 7, rows - 2);
    xn = (xn << 16) | words[row * kLanes + (cur & 127) + (int)k];
  }
  cur += (int)total;
  return xn;
}

__device__ __forceinline__ int unzigzag(uint32_t sym) {
  const int si = (int)sym;
  return (si >> 1) ^ (-(si & 1));
}

// Predictor inverse state of one lane.  VWS == 0: zzd row prefix sum;
// VWS in {1,2,4,8}: vdd previous row, chunk c of VWS (c = step % VWS is
// a compile-time constant in the unrolled step loop, so prev stays in
// registers).
template <int VWS>
struct Inverse {
  uint32_t prev[VWS > 0 ? VWS : 1];
  uint32_t rowc;
  int rcnt;
  int ws;

  __device__ __forceinline__ explicit Inverse(int ws_) : rowc(0), rcnt(0), ws(ws_) {
#pragma unroll
    for (int i = 0; i < (VWS > 0 ? VWS : 1); ++i) prev[i] = 0;
  }

  __device__ __forceinline__ uint16_t operator()(uint32_t sym, int c,
                                                 uint32_t* buf, int& phase) {
    uint32_t dz = (uint32_t)unzigzag(sym);
    if (VWS > 0) {
      const uint32_t pix = (prev[c] + dz) & 0xFFFFu;
      prev[c] = pix;
      return (uint16_t)pix;
    }
    uint32_t zero = 0, tot, tot0;
    block_scan2(dz, zero, tot, tot0, buf, phase);
    if (rcnt == 0) rowc = 0;
    const uint32_t pix = (rowc + dz) & 0xFFFFu;
    rowc = (rowc + tot) & 0xFFFFu;  // the row's last lane, carried on
    if (++rcnt >= ws) rcnt = 0;
    return (uint16_t)pix;
  }
};

template <int VWS>
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
  uint32_t x = init[li];
  const uint32_t m = mask[li], sft = shift[li];
  const uint32_t* w = words + (size_t)s * rows * kLanes;
  uint16_t* o = out + (size_t)s * steps * kLanes + lane;
  Inverse<VWS> inverse((int)ws[(size_t)s * kLanes]);
  int cur = 0, phase = 0;
  constexpr int U = VWS > 0 ? VWS : 1;
  for (int t0 = 0; t0 < steps; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const uint32_t slot = x & m;
      const uint32_t pk = slot < (uint32_t)ts ? s_tpk[slot] : 0u;
      const uint32_t rank = pk & 0xFFFu;
      const uint32_t av = rank < (uint32_t)asz ? s_alpha[rank] : 0u;
      const uint32_t xn = ((av >> 16) + 1u) * shr(x, sft) + (pk >> 12);
      const bool need = xn < (1u << 16);
      uint32_t k = need, zero = 0, total, tot0;
      block_scan2(k, zero, total, tot0, scan_buf, phase);
      x = renorm(xn, need, k - need, total, cur, w, rows);
      o[(size_t)(t0 + c) * kLanes] = inverse(av & 0xFFFFu, c, scan_buf, phase);
    }
  }
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

  uint32_t x = init[li];
  const uint32_t m = mask[li], sft = shift[li], ecmp = escv[li];
  const uint32_t* w = words + (size_t)s * rows * kLanes;
  const uint32_t* e = esides + (size_t)s * erows * kLanes;
  const int emax = erows * kLanes - 256;
  uint16_t* o = out + (size_t)s * steps * kLanes + lane;
  Inverse<VWS> inverse((int)ws[(size_t)s * kLanes]);
  int cur = 0, ecur = 0, phase = 0;
  constexpr int U = VWS > 0 ? VWS : 1;
  for (int t0 = 0; t0 < steps; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const uint32_t slot = x & m;
      const uint32_t bi = min(shr(slot, sft - 7u), 127u);
      const uint32_t off = slot & (m >> 7);
      const uint32_t g0 = s_w0[bi], g1 = s_w1[bi], g2 = s_w2[bi];
      const uint32_t t = g1 >> 24;
      const bool is_p = off < t;
      const uint32_t fm1 = (is_p ? (g1 >> 12) : (g2 >> 12)) & 0xFFFu;
      const uint32_t sb = (is_p ? g1 : g2) & 0xFFFu;
      const uint32_t j = sb + off - (is_p ? 0u : t);
      uint32_t sym = is_p ? (g0 >> 16) : (g0 & 0xFFFFu);
      const uint32_t xn = (fm1 + 1u) * shr(x, sft) + j;
      const bool need = xn < (1u << 16);
      const bool is_esc = ESC && sym == ecmp;
      uint32_t k = need, ke = is_esc, total, etot;
      block_scan2(k, ke, total, etot, scan_buf, phase);
      if (ESC) {
        if (is_esc) sym = e[min(ecur, emax) + (int)(ke - 1u)];
        ecur += (int)etot;
      }
      x = renorm(xn, need, k - need, total, cur, w, rows);
      o[(size_t)(t0 + c) * kLanes] =
          FUSED ? inverse(sym, c, scan_buf, phase) : (uint16_t)sym;
    }
  }
}

template <int VWS>
void launch_zzd(int n, size_t smem, cudaStream_t st, const uint32_t* init,
                const uint32_t* tpk, int ts, const uint32_t* alpha, int asz,
                const uint32_t* words, int rows, const uint32_t* mask,
                const uint32_t* shift, const uint32_t* ws, uint16_t* out, int steps) {
  rans_zzd_kernel<VWS><<<n, kLanes, smem, st>>>(init, tpk, ts, alpha, asz, words,
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
  launch_zzd<V>(n_strips, smem, st, (const uint32_t*)init, (const uint32_t*)tpk, ts, \
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
