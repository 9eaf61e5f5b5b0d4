// Device code of the r-mode kernel (rans_rle.cu), where one block of 128
// threads decodes one strip (thread = lane): the block scan, the logical
// shift, unzigzag and the direct predictors' inverse.  The out-of-range
// guards are listed in rans_rle.cu.

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

}  // namespace
