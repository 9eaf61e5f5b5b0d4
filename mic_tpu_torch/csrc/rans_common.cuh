// Device code shared by the rANS decode kernels (rans_decode.cu, rans_rle.cu):
// the block scan, the renorm word pull, one decode step of each FF 57 front
// end (packed tables, two tables) and the direct predictors' inverse.  One block of 128 threads decodes one strip; thread
// = lane.  The out-of-range guards are listed in rans_decode.cu.

#pragma once

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

// The rANS state of one lane and the word stream of its strip.
struct Lane {
  uint32_t x, m, sft;
  int cur;
  const uint32_t* words;
  int rows;
};

// One FF 57 step: tpk[slot] = bias<<12 | rank, alpha[rank] = (freq-1)<<16 |
// sym, both in shared memory.  Returns the symbol.
struct PackedFront {
  const uint32_t* tpk;
  int ts;
  const uint32_t* alpha;
  int asz;

  __device__ __forceinline__ uint32_t step(Lane& l, uint32_t* buf, int& phase) const {
    const uint32_t slot = l.x & l.m;
    const uint32_t pk = slot < (uint32_t)ts ? tpk[slot] : 0u;
    const uint32_t rank = pk & 0xFFFu;
    const uint32_t av = rank < (uint32_t)asz ? alpha[rank] : 0u;
    const uint32_t xn = ((av >> 16) + 1u) * shr(l.x, l.sft) + (pk >> 12);
    const bool need = xn < (1u << 16);
    uint32_t k = need, zero = 0, total, tot0;
    block_scan2(k, zero, total, tot0, buf, phase);
    l.x = renorm(xn, need, k - need, total, l.cur, l.words, l.rows);
    return av & 0xFFFFu;
  }
};

// One FF 57 step of the two-table form (tableLog up to 16, any alphabet):
// tsym[slot] = sym, tfb[slot] = freq<<16 | bias, in shared memory where
// they fit, else read from device memory.  Returns the symbol.
struct TwoTableFront {
  const uint32_t* tsym;
  const uint32_t* tfb;
  int ts;

  __device__ __forceinline__ uint32_t step(Lane& l, uint32_t* buf, int& phase) const {
    const uint32_t slot = l.x & l.m;
    const bool in = slot < (uint32_t)ts;
    const uint32_t sym = in ? tsym[slot] : 0u;
    const uint32_t fb = in ? tfb[slot] : 0u;
    const uint32_t xn = (fb >> 16) * shr(l.x, l.sft) + (fb & 0xFFFFu);
    const bool need = xn < (1u << 16);
    uint32_t k = need, zero = 0, total, tot0;
    block_scan2(k, zero, total, tot0, buf, phase);
    l.x = renorm(xn, need, k - need, total, l.cur, l.words, l.rows);
    return sym;
  }
};

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

}  // namespace
