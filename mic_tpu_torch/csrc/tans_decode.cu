// Interleaved tANS decode of the reference's entropy streams for Hopper.
//
// tans_kernel<N> replaces mic_tpu/tpu/pallas_tans.py:_kernel_tans (wrapper
// tans_decode_pallas): N-state interleaved tANS (magic FF 02 / 04 / 84,
// N = 2 / 4 / 8) and, through an rANS decode table, FF 08.  The streams
// are reverse bitstreams read at bit granularity with one bit cursor per
// stream.  Per step, lane j < N of a stream:
//   pk   = tpk[x]                       (rank << 19 | newState << 5 | nb)
//   sym  = alpha[rank] & 0xFFFF         -> out[t * N + j] (0 if inactive)
//   cum  = inclusive sum of nb over lanes 0..j (inactive lanes: nb = 0)
//   x'   = newState + bits [pos - cum, pos - cum + nb) of the stream
//   pos -= cum of lane N - 1
// where a lane is active while t * N + j < count.
//
// Design: one warp per stream (one block of 32 threads), lanes 0..N-1
// hold the N states.  The stream's packed table (2^tl words, at least
// 128) and alphabet (asweep * 128 words) sit in dynamic shared memory:
// at most 32 KB + 16 KB at tl 13 with 4096 symbols, so the 48 KB default
// holds them; cudaFuncSetAttribute is set anyway above it.  The lane
// prefix sum is N-lane __shfl_up_sync (the Pallas kernel's bf16 matmul),
// the total comes from lane N - 1, and each lane's bits come from two
// __ldg word reads joined by __funnelshift_r.  The Pallas kernel's
// sublane blocking, window refill and lane-roll output packing have no
// counterpart: the output index t * N + j lands in order directly.
//
// What bounds it on this card: the decode is one serial chain of
// dependent steps per stream (table read -> bit count -> lane scan ->
// word read -> next state), 8 to 104 bits a step, so the kernel is
// latency-bound, and only N of 32 lanes work.  Many streams (one block
// each) hide the step latency, but only as many as fit the SMs at once:
// the shared memory is sized for the launch's largest table and
// alphabet, so at tl 13 (32 KB of table plus 0.5-16 KB of alphabet) four
// or five blocks fit an SM and a launch of more than 4-5 x 132 streams
// runs in waves.  A block stops once its own count is decoded, zeroing
// its remaining rows, so a short stream frees its slot for the next wave
// instead of running the launch's longest chain (the host orders a
// launch's streams longest first).  A stream's words are read in order
// and stay in L1.
//
// Out-of-range guards, shared with the plain version in
// mic_tpu_torch/tpu/tans_decode.py (valid operands never need the first
// two): a state at or past the table (ts) and a rank at or past the
// alphabet (asz) read 0; each output row of 128 / N steps reads through
// the Pallas kernel's 256-word window, whose first block is
// max(pos - 128 * tl - 64, 0) >> 12, clamped to wb - 2, and every word
// index clamps into it ([base, base + 254] and the word after), so reads
// below bit 0 (after a lane's last symbol, or from an over-claimed count)
// and past the stream stay in the array.  No shift reaches 32: the
// funnel shift takes the offset mod 32 and nb < 32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

template <int N>
__global__ void __launch_bounds__(32)
tans_kernel(const uint32_t* __restrict__ init, const int32_t* __restrict__ pos0,
            const int32_t* __restrict__ cnt, const uint32_t* __restrict__ tpk, int ts,
            const uint32_t* __restrict__ alpha, int asz, const uint32_t* __restrict__ words,
            int wb, uint16_t* __restrict__ out, int steps, int table_log) {
  constexpr int SPR = 128 / N;  // steps per 128-symbol output row
  extern __shared__ uint32_t smem[];
  uint32_t* s_tpk = smem;
  uint32_t* s_alpha = smem + ts;
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < ts; i += 32) s_tpk[i] = tpk[(size_t)s * ts + i];
  for (int i = lane; i < asz; i += 32) s_alpha[i] = alpha[(size_t)s * asz + i];
  __syncthreads();

  const uint32_t* w = words + (size_t)s * wb * 128;
  uint16_t* o = out + (size_t)s * steps * N;
  const int count = cnt[(size_t)s * 128];  // int32 compare, as the Pallas kernel's
  const int max_base = (wb - 2) * 128;
  uint32_t x = init[(size_t)s * 128 + lane];
  int pos = pos0[(size_t)s * 128];
  for (int t0 = 0; t0 < steps; t0 += SPR) {
    if (t0 * N >= count) {
      // No lane is active from here on (count is the warp's own, so the
      // exit is warp-uniform): zero the remaining rows, 8 symbols a store
      // (each row starts 256-byte aligned), and free the SM.
      uint4* o4 = reinterpret_cast<uint4*>(o + (size_t)t0 * N);
      for (int i = lane; i < (steps - t0) * N / 8; i += 32) o4[i] = make_uint4(0, 0, 0, 0);
      return;
    }
    const int low = max(pos - 128 * table_log - 64, 0);
    const int base = min((low >> 12) << 7, max_base);
    for (int t = t0; t < t0 + SPR; ++t) {
      const uint32_t pk = x < (uint32_t)ts ? s_tpk[x] : 0u;
      const uint32_t rank = pk >> 19;
      const uint32_t sym = rank < (uint32_t)asz ? s_alpha[rank] & 0xFFFFu : 0u;
      const bool active = lane < N && t * N + lane < count;
      const uint32_t nb = active ? (pk & 31u) : 0u;
      uint32_t cum = nb;
#pragma unroll
      for (int d = 1; d < N; d <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, cum, d);
        if (lane >= d) cum += v;
      }
      const int total = (int)__shfl_sync(kFull, cum, N - 1);
      const int start = pos - (int)cum;
      const int idx = base + min(max((start >> 5) - base, 0), 254);
      const uint32_t lo = __ldg(w + idx), hi = __ldg(w + idx + 1);
      const uint32_t val = __funnelshift_r(lo, hi, (uint32_t)start & 31u) & ((1u << nb) - 1u);
      if (active) x = ((pk >> 5) & 0x3FFFu) + val;
      pos -= total;
      if (lane < N) o[(size_t)t * N + lane] = active ? (uint16_t)sym : (uint16_t)0;
    }
  }
}

template <int N>
cudaError_t launch(int n_streams, size_t smem, cudaStream_t st, const uint32_t* init,
                   const int32_t* pos, const int32_t* cnt, const uint32_t* tpk, int ts,
                   const uint32_t* alpha, int asz, const uint32_t* words, int wb,
                   uint16_t* out, int steps, int table_log) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tans_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  tans_kernel<N><<<n_streams, 32, smem, st>>>(init, pos, cnt, tpk, ts, alpha, asz, words, wb,
                                              out, steps, table_log);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaErrorInvalidValue for an n_states the kernel does not take,
// else the launch's error (cudaGetLastError()).
int mic_tans_decode(const void* init, const void* pos, const void* cnt, const void* tpk,
                    int ts, const void* alpha, int asz, const void* words, int wb, void* out,
                    int n_streams, int steps, int n_states, int table_log, void* stream) {
  const size_t smem = (size_t)(ts + asz) * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define MIC_TANS(N_)                                                                     \
  launch<N_>(n_streams, smem, st, (const uint32_t*)init, (const int32_t*)pos,            \
             (const int32_t*)cnt, (const uint32_t*)tpk, ts, (const uint32_t*)alpha, asz, \
             (const uint32_t*)words, wb, (uint16_t*)out, steps, table_log)
  switch (n_states) {
    case 2: return (int)MIC_TANS(2);
    case 4: return (int)MIC_TANS(4);
    case 8: return (int)MIC_TANS(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIC_TANS
}

}  // extern "C"
