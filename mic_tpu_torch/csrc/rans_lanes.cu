// L-lane rANS decode of MICT strips for Hopper: the entropy stage of the
// scan tier, for strips at any power-of-two lane count and FF 41 strips
// above tableLog 12, which the 128-lane kernels (rans_direct.cu,
// rans_rle.cu) do not take.  Every scan bucket of a decode plan runs in one
// launch; the post stage (SoA-RLE expand, escape parse, predictor inverse)
// follows in torch ops (tpu/post.py:post_batch).
//
// lanes_groups_kernel replaces no Pallas kernel: mic_tpu runs this tier in
// plain XLA, mic_tpu/tpu/strips.py:decode_strip_batch_impl, its rans_one
// (the lax.scan over L-lane steps, :762) and subst_one (the escape
// substitution, :784).  It computes exactly what they compute, per step of
// a strip:
//
//   slot = x & mask; sym = tsym[slot]; (f, b) = (tf, tb)[slot]
//   x' = f * (x >> tl) + b                       (u32, wrapping)
//   active = t * L + lane < count
//   need = x' < 2^16 && active
//   x' = need ? x' << 16 | words[min(cursor + rank(need), W - 1)] : x'
//   cursor += total(need); x = active ? x' : x
//   out[t * L + lane] = sym, every lane, inactive ones included
//
// and then, in stream order over the whole strip, every symbol equal to
// the strip's escape value (-1 for FF 57: none) takes the side stream's
// value at its escape rank, clipped to the side's last index.
//
// What bounds it on this card: a strip is a serial chain of dependent
// steps (a 1024-step strip of 64 lanes moves 128 KB of symbols and ~55 KB
// of words), so a launch lasts its longest chain; the batch's bytes take
// tens of microseconds.  The design is the simple one: a block per strip
// and a thread per lane, the block as wide as the launch's widest strip up
// to 1024 threads; a strip of more lanes gives each thread lanes j * 1024
// + tid, and the warps past a narrower strip's lanes leave at the start
// (the steps' barriers are named barriers over the strip's own threads).
// The renorm ranks and the escape ranks come from one exclusive block scan
// a step: two warp ballots and popcounts, the warps' totals (both counts
// packed in one word, 16 bits each: a step counts at most 16,384 lanes)
// scanned by warp 0, two barriers.  A strip's tables (6 bytes a slot as
// tsym and tfb = freq << 16 | bias where every freq and bias of the group
// fit 16 bits, else 10 as tsym, tf and tb) are read from device memory at
// every tableLog, through L1: staging them in shared memory measured
// slower on the H100 (PERF.md, row 11), and every block of a launch would
// ask for the largest staged table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// One bucket (tpu/scan_decode.py:_LANE_GROUP_DESC): operand pointers, the
// element offset of its output in the launch's flat buffer, and its shape.
struct LaneGroup {
  const uint32_t* init;     // [S, L] initial states
  const uint16_t* words;    // [S, W] renorm words (W - 1 of them at most, a zero after)
  const uint16_t* tsym;     // [N] every strip's slot symbols, at toff[s]
  const uint32_t* tfb;      // [N] freq << 16 | bias (form 0), or freq (form 1)
  const uint32_t* tb;       // [N] bias (form 1)
  const int32_t* toff;      // [S] a strip's table offset
  const int32_t* tls;       // [S] a strip's tableLog, 0-17
  const int32_t* counts;    // [S] symbols
  const int32_t* escv;      // [S] escape value, -1 for none
  const uint16_t* esides;   // [S, E] escape side streams
  int64_t off;
  int32_t lanes, W, E, steps, form, pad;
};

// A named barrier over the first n threads of the block (n a multiple of
// 32): the warps past a strip's lanes leave the block at its start.
__device__ __forceinline__ void bar_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

template <int LPT>
__global__ void __launch_bounds__(1024) lanes_groups_kernel(const LaneGroup* __restrict__ groups,
                                                            const int2* __restrict__ blocks,
                                                            uint16_t* __restrict__ out) {
  __shared__ uint32_t tot[LPT * 32];
  __shared__ uint32_t pre[LPT * 32 + 1];
  const int2 bd = blocks[blockIdx.x];
  const LaneGroup g = groups[bd.x];
  const int s = bd.y;
  const int L = g.lanes, W = g.W, E = g.E, form = g.form;
  // The strip's threads: a thread a lane up to the block's size, at least
  // a warp; each thread takes lanes j * used + tid for j < lpt.
  const int used = min((int)blockDim.x, max(32, L));
  const int tid = threadIdx.x;
  if (tid >= used) return;
  const int warp = tid >> 5, ln = tid & 31, nw = used >> 5;
  const int lpt = (L + used - 1) / used, n_tot = lpt * nw;
  const int tl = g.tls[s];
  const uint32_t mask = (1u << tl) - 1u;
  const int count = g.counts[s];
  const int escv = g.escv[s];
  const uint16_t* words = g.words + (int64_t)s * W;
  const uint16_t* side = g.esides + (int64_t)s * E;
  const int64_t to = g.toff[s];
  const uint16_t* tsym = g.tsym + to;
  const uint32_t* tfb = g.tfb + to;
  const uint32_t* tb = form ? g.tb + to : nullptr;
  uint32_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int lane = j * used + tid;
    x[j] = j < lpt && lane < L ? g.init[(int64_t)s * L + lane] : 0u;
  }
  uint16_t* o = out + g.off + (int64_t)s * g.steps * L;
  const uint32_t lt = (1u << ln) - 1u;
  uint32_t cursor = 0;
  int ecur = 0;
#pragma unroll 1
  for (int t = 0; t < g.steps; ++t) {
    uint32_t xn[LPT], sym[LPT], rk[LPT];
    bool need[LPT], esc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (j >= lpt) break;
      const int lane = j * used + tid;
      const bool valid = lane < L;
      const uint32_t slot = x[j] & mask;
      uint32_t f = 0, b = 0;
      sym[j] = 0;
      if (valid) {
        sym[j] = tsym[slot];
        if (form) {
          f = tfb[slot];
          b = tb[slot];
        } else {
          const uint32_t fb = tfb[slot];
          f = fb >> 16;
          b = fb & 0xFFFFu;
        }
      }
      xn[j] = f * (x[j] >> tl) + b;
      const bool active = valid && (int64_t)t * L + lane < (int64_t)count;
      need[j] = active && xn[j] < 65536u;
      esc[j] = valid && (int)sym[j] == escv;
      if (!active) xn[j] = x[j];
      const uint32_t bn = __ballot_sync(kFull, need[j]);
      const uint32_t be = __ballot_sync(kFull, esc[j]);
      rk[j] = __popc(bn & lt) | (__popc(be & lt) << 16);
      if (ln == 0) tot[j * nw + warp] = __popc(bn) | (__popc(be) << 16);
    }
    bar_sync(used);
    if (warp == 0) {  // exclusive scan of the n_tot warp totals, lane order
      const int per = (n_tot + 31) >> 5;
      uint32_t sum = 0;
      for (int k = 0; k < per; ++k) {
        const int i = ln * per + k;
        if (i < n_tot) sum += tot[i];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, incl, d);
        if (ln >= d) incl += y;
      }
      uint32_t run = incl - sum;
      for (int k = 0; k < per; ++k) {
        const int i = ln * per + k;
        if (i < n_tot) {
          pre[i] = run;
          run += tot[i];
        }
      }
      if (ln == 31) pre[n_tot] = incl;
    }
    bar_sync(used);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (j >= lpt) break;
      const int lane = j * used + tid;
      if (lane >= L) continue;
      const uint32_t base = pre[j * nw + warp];
      if (need[j]) {
        uint32_t i = cursor + (base & 0xFFFFu) + (rk[j] & 0xFFFFu);
        i = min(i, (uint32_t)(W - 1));
        xn[j] = (xn[j] << 16) | words[i];
      }
      x[j] = xn[j];
      uint32_t v = sym[j];
      if (esc[j]) {
        const int r = ecur + (int)(base >> 16) + (int)(rk[j] >> 16);
        v = side[min(r, E - 1)];
      }
      o[(int64_t)t * L + lane] = (uint16_t)v;
    }
    const uint32_t total = pre[n_tot];
    cursor += total & 0xFFFFu;
    ecur += (int)(total >> 16);
  }
}

template <int LPT>
int launch(const void* groups, const void* blocks, int n_blocks, void* out, int threads,
           void* stream) {
  lanes_groups_kernel<LPT><<<n_blocks, threads, 0, (cudaStream_t)stream>>>(
      (const LaneGroup*)groups, (const int2*)blocks, (uint16_t*)out);
  return (int)cudaGetLastError();
}

template <int LPT>
int shape(int threads, int* res) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, lanes_groups_kernel<LPT>);
  if (e != cudaSuccess) return (int)e;
  res[0] = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[1], lanes_groups_kernel<LPT>,
                                                            threads, 0);
}

}  // namespace

extern "C" {

// groups: LaneGroup[] and blocks: int2[n_blocks] (group, strip), both on
// the device; out: the flat buffer the groups' offsets index; threads: a
// block's threads, a multiple of 32 up to 1024; lpt: lanes a thread, 1-16.
int mic_lanes_decode_groups(const void* groups, const void* blocks, int n_blocks, void* out,
                            int threads, int lpt, void* stream) {
  if (n_blocks <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  switch (lpt) {
    case 1: return launch<1>(groups, blocks, n_blocks, out, threads, stream);
    case 2: return launch<2>(groups, blocks, n_blocks, out, threads, stream);
    case 4: return launch<4>(groups, blocks, n_blocks, out, threads, stream);
    case 8: return launch<8>(groups, blocks, n_blocks, out, threads, stream);
    case 16: return launch<16>(groups, blocks, n_blocks, out, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's shape at `threads` threads a block and `lpt` lanes a
// thread: out (int[2]) gets its shared bytes a block (static: the scan's
// warp totals) and its blocks resident on one SM.  Returns a CUDA error.
int mic_lanes_shape(int threads, int lpt, int* out) {
  switch (lpt) {
    case 1: return shape<1>(threads, out);
    case 2: return shape<2>(threads, out);
    case 4: return shape<4>(threads, out);
    case 8: return shape<8>(threads, out);
    case 16: return shape<16>(threads, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
