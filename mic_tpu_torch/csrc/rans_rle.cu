// Fused r-mode decode of MICW (zzr / vdr / pdr) for Hopper: rANS, SoA-RLE
// expand and the direct predictors' inverse in one kernel, one launch per
// bucket.  One block of 128 threads per strip, thread = lane:
//
// * rans_rle_kernel replaces mic_tpu/tpu/pallas_rans.py:_kernel_rle
//   (wrapper rans_decode_pallas_rle): the FF 57 packed-table front end;
// * rans_rle_alias_kernel replaces pallas_rans.py:_kernel_rle_alias
//   (wrapper rans_decode_pallas_rle_alias): the FF 41 alias front end,
//   escapes included.
//
// Both share rle_strip below, which runs the three phases of
// pallas_rans.py:_expand_rle_phase behind the front end:
//
// 1.   Entropy: steps x 128 symbols into the strip's u16 scratch row
//      (stream order = step-major), with the step code of rans_decode.cu.
// 1.5. Run tables from the counts section (the first nrun symbols), R =
//      maxr / 128 rows: exclusive block scans of run lengths, literal
//      lengths and same-flags, carried across rows; st1 = start<<1 |
//      is_same (kHuge past nrun), st2 = the same-run value syms[nrun +
//      rank] or the literal source offset nrun + nsame + lstart - start.
// 2.   Expand, one 128-px output row per step: each thread finds the run
//      holding its position t*128 + lane, takes the same value or the
//      literal syms[st2 + pos], then unzigzag and the zzr/pdr row prefix
//      sum with its reset every ws rows or the vdr previous-row carry.
//
// Run search: run starts strictly increase on an honest stream, so the
// run holding pos is the last one whose start <= pos, and a 128-px row
// plus the next row's first position spans at most 129 runs past rb, the
// run holding the row's first position (carried from row to row).  A
// branch-free binary search over st1[rb .. rb + W) therefore finds it for
// both grammars with W = 256; a FLAG_RDENSE stream (same-runs >= 16 px,
// so at most 18 runs in any 129 positions) takes W = 32.  The Pallas
// kernel's window searches give the same run on every honest stream.
//
// What bounds it on this card: like rans_decode.cu, a serial chain per
// strip: steps entropy steps with one or two barriers each, then out_rows
// expand rows, each two dependent binary searches of log2(W) global reads
// (L1-resident: the current rows' table entries), one literal read, one
// barrier (__syncthreads_count of the literal lanes) and for zzr/pdr a
// block scan.  The symbol scratch (steps x 256 B per strip) and the run
// tables (8 B per run-table entry) live in device memory the wrapper
// allocates, so the occupancy stays that of the direct kernels (shared
// memory holds only the entropy tables) whatever maxr is.
//
// Guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (honest streams never reach them):
// those of rans_decode.cu for the front end; a symbol keeps its low 16
// bits (side-stream values are u16); nrun clamps to [0, maxr] and nsame
// to [0, steps * 128]; the run-length and literal-length carries saturate
// at 2^29 (so no int32 sum overflows); the same-value and literal reads go
// through the Pallas kernel's 256-entry windows (first row clamped to
// [0, steps - 2], offset to [0, 255]); the literal cursor clamps to
// steps * 128 - 1; the search never reads past st1[maxr - 1].
//
// Build: see rans_decode.cu.  Each C entry point returns
// cudaErrorInvalidValue for a vdd_ws the kernels do not take, else
// cudaGetLastError() after its launch.

#include "rans_common.cuh"

namespace {

constexpr int kMid = 16383;     // MID_DIRECT: counts <= kMid are same-runs
constexpr int kHuge = 1 << 30;  // st1 past nrun: start 2^29, never <= pos
constexpr int kCap = 1 << 29;   // saturation of the length carries

// Last run r in [rb, min(rb + W, maxr) - 1] whose start <= pos (rb if none).
template <int W>
__device__ __forceinline__ int find_run(const int* st1, int rb, int pos, int maxr) {
  int r = rb;
#pragma unroll
  for (int step = W / 2; step > 0; step >>= 1) {
    const int c = r + step;
    if (c < maxr && (st1[c] >> 1) <= pos) r = c;
  }
  return r;
}

template <int VWS, bool DENSE, class Front>
__device__ __forceinline__ void rle_strip(Front& front, Lane& l, uint16_t* syms,
                                          int* st1, int* st2, int nrun, int nsame,
                                          int ws, uint16_t* out, int steps,
                                          int out_rows, int maxr, uint32_t* buf) {
  const int lane = threadIdx.x;
  int phase = 0;
  // 1. entropy
  for (int t = 0; t < steps; ++t)
    syms[t * kLanes + lane] = (uint16_t)front.step(l, buf, phase);
  __syncthreads();

  // 1.5 run tables
  nrun = min(max(nrun, 0), maxr);
  nsame = min(max(nsame, 0), steps * kLanes);
  int len_c = 0, same_c = 0, lit_c = 0;
  for (int rr = 0; rr < maxr / kLanes; ++rr) {
    const int ridx = rr * kLanes + lane;
    const int c = syms[ridx];
    const bool valid = ridx < nrun;
    const bool is_s = valid && c <= kMid;
    const uint32_t len = valid ? (uint32_t)(is_s ? c : c - kMid) : 0u;
    const uint32_t litl = is_s ? 0u : len;
    uint32_t a = len, b = litl, ta, tb, si = is_s, zero = 0, tsi, tz;
    block_scan2(a, b, ta, tb, buf, phase);
    block_scan2(si, zero, tsi, tz, buf, phase);
    const int start = len_c + (int)(a - len);
    const int rank = same_c + (int)(si - (uint32_t)is_s);
    const int lstart = lit_c + (int)(b - litl);
    const int wrow = min(max((nrun + same_c) >> 7, 0), steps - 2);
    const int loc = min(max(nrun + rank - (wrow << 7), 0), 255);
    st1[ridx] = valid ? (start << 1) | (int)is_s : kHuge;
    st2[ridx] = is_s ? (int)syms[(wrow << 7) + loc] : nrun + nsame + lstart - start;
    len_c = min(len_c + (int)ta, kCap);
    same_c += (int)tsi;
    lit_c = min(lit_c + (int)tb, kCap);
  }
  __syncthreads();

  // 2. expand + inverse
  constexpr int W = DENSE ? 32 : 256;
  constexpr int U = VWS > 0 ? VWS : 1;
  const int lmax = steps * kLanes - 1;
  Inverse<VWS> inverse(ws);
  int rb = 0, lc = nrun + nsame;
  for (int t0 = 0; t0 < out_rows; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const int row0 = (t0 + c) * kLanes, pos = row0 + lane;
      const int r = find_run<W>(st1, rb, pos, maxr);
      const int rn = find_run<W>(st1, rb, row0 + kLanes, maxr);
      const int g1 = st1[r], g2 = st2[r];
      const bool is_s = g1 & 1;
      const int lrow = min(lc >> 7, steps - 2);
      const int li = min(max(g2 + pos - (lrow << 7), 0), 255);
      const int tok = is_s ? g2 : (int)syms[(lrow << 7) + li];
      lc = min(lc + __syncthreads_count(!is_s), lmax);
      rb = rn;
      out[(size_t)row0 + lane] = inverse((uint32_t)tok, c, buf, phase);
    }
  }
}

template <int VWS, bool DENSE>
__global__ void __launch_bounds__(kLanes)
rans_rle_kernel(const uint32_t* __restrict__ init, const uint32_t* __restrict__ tpk,
                int ts, const uint32_t* __restrict__ alpha, int asz,
                const uint32_t* __restrict__ words, int rows,
                const uint32_t* __restrict__ mask, const uint32_t* __restrict__ shift,
                const int* __restrict__ ws, const int* __restrict__ nrun,
                const int* __restrict__ nsame, uint16_t* __restrict__ out,
                uint16_t* syms, int* st1, int* st2, int steps, int out_rows, int maxr) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t scan_buf[16];
  uint32_t* s_tpk = smem;
  uint32_t* s_alpha = smem + ts;
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < ts; i += kLanes) s_tpk[i] = tpk[(size_t)s * ts + i];
  for (int i = lane; i < asz; i += kLanes) s_alpha[i] = alpha[(size_t)s * asz + i];
  __syncthreads();

  const size_t li = (size_t)s * kLanes + lane, s0 = (size_t)s * kLanes;
  PackedFront front{s_tpk, ts, s_alpha, asz};
  Lane l{init[li], mask[li], shift[li], 0, words + (size_t)s * rows * kLanes, rows};
  rle_strip<VWS, DENSE>(front, l, syms + (size_t)s * steps * kLanes,
                        st1 + (size_t)s * maxr, st2 + (size_t)s * maxr, nrun[s0],
                        nsame[s0], ws[s0], out + (size_t)s * out_rows * kLanes, steps,
                        out_rows, maxr, scan_buf);
}

template <int VWS, bool DENSE, bool ESC>
__global__ void __launch_bounds__(kLanes)
rans_rle_alias_kernel(const uint32_t* __restrict__ init, const uint32_t* __restrict__ w0,
                      const uint32_t* __restrict__ w1, const uint32_t* __restrict__ w2,
                      const uint32_t* __restrict__ words, int rows,
                      const uint32_t* __restrict__ mask, const uint32_t* __restrict__ shift,
                      const uint32_t* __restrict__ escv,
                      const uint32_t* __restrict__ esides, int erows,
                      const int* __restrict__ ws, const int* __restrict__ nrun,
                      const int* __restrict__ nsame, uint16_t* __restrict__ out,
                      uint16_t* syms, int* st1, int* st2, int steps, int out_rows,
                      int maxr) {
  __shared__ uint32_t s_w0[kLanes], s_w1[kLanes], s_w2[kLanes];
  __shared__ uint32_t scan_buf[16];
  const int s = blockIdx.x, lane = threadIdx.x;
  const size_t li = (size_t)s * kLanes + lane, s0 = (size_t)s * kLanes;
  s_w0[lane] = w0[li];
  s_w1[lane] = w1[li];
  s_w2[lane] = w2[li];
  __syncthreads();

  AliasFront<ESC> front{s_w0, s_w1, s_w2, escv[li], esides + (size_t)s * erows * kLanes,
                        erows * kLanes - 256, 0};
  Lane l{init[li], mask[li], shift[li], 0, words + (size_t)s * rows * kLanes, rows};
  rle_strip<VWS, DENSE>(front, l, syms + (size_t)s * steps * kLanes,
                        st1 + (size_t)s * maxr, st2 + (size_t)s * maxr, nrun[s0],
                        nsame[s0], ws[s0], out + (size_t)s * out_rows * kLanes, steps,
                        out_rows, maxr, scan_buf);
}

// The (vdd_ws, dense) template instance for a launch; false for a vdd_ws
// the kernels do not take.
#define MIC_RLE_DISPATCH(LAUNCH)      \
  switch (vdd_ws * 2 + (dense != 0)) { \
    case 0: LAUNCH(0, false); break;   \
    case 1: LAUNCH(0, true); break;    \
    case 2: LAUNCH(1, false); break;   \
    case 3: LAUNCH(1, true); break;    \
    case 4: LAUNCH(2, false); break;   \
    case 5: LAUNCH(2, true); break;    \
    case 8: LAUNCH(4, false); break;   \
    case 9: LAUNCH(4, true); break;    \
    case 16: LAUNCH(8, false); break;  \
    case 17: LAUNCH(8, true); break;   \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

int mic_rans_decode_rle(const void* init, const void* tpk, int ts, const void* alpha,
                        int asz, const void* words, int rows, const void* mask,
                        const void* shift, const void* ws, const void* nrun,
                        const void* nsame, void* out, void* syms, void* st1, void* st2,
                        int n_strips, int steps, int out_rows, int maxr, int vdd_ws,
                        int dense, void* stream) {
  const size_t smem = (size_t)(ts + asz) * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define MIC_RLE(V, D)                                                                   \
  rans_rle_kernel<V, D><<<n_strips, kLanes, smem, st>>>(                                \
      (const uint32_t*)init, (const uint32_t*)tpk, ts, (const uint32_t*)alpha, asz,     \
      (const uint32_t*)words, rows, (const uint32_t*)mask, (const uint32_t*)shift,      \
      (const int*)ws, (const int*)nrun, (const int*)nsame, (uint16_t*)out,              \
      (uint16_t*)syms, (int*)st1, (int*)st2, steps, out_rows, maxr)
  MIC_RLE_DISPATCH(MIC_RLE)
#undef MIC_RLE
  return (int)cudaGetLastError();
}

int mic_rans_decode_rle_alias(const void* init, const void* w0, const void* w1,
                              const void* w2, const void* words, int rows,
                              const void* mask, const void* shift, const void* escv,
                              const void* esides, int erows, const void* ws,
                              const void* nrun, const void* nsame, void* out, void* syms,
                              void* st1, void* st2, int n_strips, int steps, int out_rows,
                              int maxr, int vdd_ws, int dense, int esc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define MIC_RLE_ALIAS(V, D)                                                              \
  if (esc)                                                                               \
    MIC_RLE_ALIAS_E(V, D, true);                                                         \
  else                                                                                   \
    MIC_RLE_ALIAS_E(V, D, false)
#define MIC_RLE_ALIAS_E(V, D, E)                                                         \
  rans_rle_alias_kernel<V, D, E><<<n_strips, kLanes, 0, st>>>(                           \
      (const uint32_t*)init, (const uint32_t*)w0, (const uint32_t*)w1,                   \
      (const uint32_t*)w2, (const uint32_t*)words, rows, (const uint32_t*)mask,          \
      (const uint32_t*)shift, (const uint32_t*)escv, (const uint32_t*)esides, erows,     \
      (const int*)ws, (const int*)nrun, (const int*)nsame, (uint16_t*)out,               \
      (uint16_t*)syms, (int*)st1, (int*)st2, steps, out_rows, maxr)
  MIC_RLE_DISPATCH(MIC_RLE_ALIAS)
#undef MIC_RLE_ALIAS_E
#undef MIC_RLE_ALIAS
  return (int)cudaGetLastError();
}

}  // extern "C"
