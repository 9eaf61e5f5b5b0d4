// The post stage of MICW decode for Hopper: what follows a symbols-out
// entropy kernel for the strips the fused kernels do not take, every post
// bucket of a decode plan in one launch.
//
// post_groups_kernel has no Pallas counterpart.  It replaces mic_tpu's
// post program, plain XLA: mic_tpu/tpu/strips.py:1824-1840
// (_micw_post_batch, a jax.jit of the vmap of _post_one_strip, :686-727)
// over mic_tpu/tpu/pipeline.py:114-350 (soa_rle_expand_device,
// parse_escaped_device, zz_delta_inverse_device, avg_delta_inverse_device
// and the zzd / vdd / pdd inverses).  Per strip of a bucket, as
// mic_tpu_torch/tpu/post.py:post_batch (its plain twin) computes it:
//   zzd / vdd / pdd  the symbols (zero past the entropy output) through
//                    the direct inverse: unzigzag, then the row prefix,
//                    the column prefix, or both, mod 2^16;
//   zzr / vdr / pdr  the SoA-RLE expand (counts, same-run values,
//                    literals), then the direct inverse;
//   zz / avg         the expand, the escape parse of tokens[1:] (token 0
//                    is the strip's maxValue word; every maximal run of
//                    delim tokens starts at a token boundary, so its even
//                    offsets are escape markers and the token after each
//                    is a raw pixel), then the segmented left-delta
//                    inverse (zz) or the avg(left, top) inverse (avg).
// Every clamp of the twin holds, so damaged streams give its output bit
// for bit: gathers clipped to the stream, tokens past the expand's count
// 0, a pixel past the count of token starts takes position 0's value,
// outputs masked to 16 bits.
//
// What bounds it on this card.  The bytes are the symbols in and the
// pixels out (phase 6 of chip_smoke.py: ~80 M pixels, near 0.1 ms at
// 3.35 TB/s).  Against them stand serial chains: the avg inverse is
// 2(h - 1) + w dependent wavefront steps a strip (510 for a 256 x 128
// strip), and the expand and the parse are scans over a strip's runs and
// tokens.  The twin ran these as a loop of torch launches on the host (510
// steps of several launches each for one avg bucket).  Here the chains
// stay inside a block:
//
// 1. A block per strip, kThreads threads; the blocks of avg strips come
//    first in the launch (their chains are the longest), then zz, then
//    the rest (post.py: PostPacking orders them).
// 2. The runs: each thread takes a contiguous span of the strip's valid
//    runs, sums its lengths, literal lengths and same-run count, one block
//    scan gives each span its starts, and a second walk writes each run's
//    start and its token source (a same-run value, or the offset of its
//    literals in the stream) to a scratch in device memory (16 bytes a run).
// 3. The tokens: a thread takes a contiguous span of positions, finds its
//    first position's run by a binary search over the run starts and walks
//    forward from there (the starts never decrease, so the last run whose
//    start is <= a position is the twin's binary-search answer).
// 4. The escape parse: marker[j] = delim[j] && !marker[j - 1], and j is a
//    token start where marker[j - 1] is false.  A span's effect is a map of
//    its incoming marker bit to (outgoing bit, token starts); a thread
//    walks its span once for both incoming bits, one block scan composes
//    the maps, a second walk writes each token start's pixel (the next
//    token for a marker) at its rank into the strip's output row, in
//    place, and its raw flag into a byte scratch.  Ranks past the count of
//    token starts take position 0's pixel, as the twin's zeroed scatter
//    does.
// 5. The inverses, in place on the output row: the row prefix (zzd, pdd's
//    first pass, zz's segmented form restarting at every raw pixel) a warp
//    a row, 32 pixels a round through a shuffle ladder; the column prefix
//    (vdd, pdd's second pass) a thread a column; avg a thread a row (a
//    thread takes several rows when strip_h exceeds the block): at step k
//    row i does column j = k - 2i, "left" is its own value of step k - 1
//    and "top" row i - 1's of step k - 2, both from a ring of 4 steps x
//    strip_h values in shared memory, one barrier a step.
//
// Shared memory: the two scan buffers (10 KB) and the avg ring, 8 bytes a
// row of the launch's tallest avg strip (post.py refuses a ring past the
// block's 227 KB).  Device scratch, made by the wrapper: the runs (16
// bytes a run of max_runs a strip) and the raw flags (a byte a pixel of
// the zz / avg strips).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 128;           // buckets a launch (post.py: MAX_GROUPS)
constexpr long long kSameTag = 1LL << 62;  // Run::info of a same-run: kSameTag + value
constexpr unsigned kFull = 0xffffffffu;

// post.py: PREDICTORS
enum Pred { kZzd = 0, kVdd, kPdd, kZzr, kVdr, kPdr, kZz, kAvg };

// One bucket's post stage (post.py: _GROUP_DESC, 64 bytes).
struct Group {
  const long long* meta;  // [S, 3]: n_tokens, n_runs, n_same (the table entries)
  long long out_off;      // its output's first element in out
  long long runs_off;     // its first Run in the runs scratch (max_runs a strip)
  long long flags_off;    // its first byte in the flags scratch (zz / avg: a byte a pixel)
  int width, strip_h, max_runs, max_tokens, mid, delim, pred, pad;
};

// One launch's entropy outputs: int16 [S, cols] each, contiguous.
struct Ents {
  const uint16_t* p[kMaxGroups];
  int cols[kMaxGroups];
};

// A run of the SoA-RLE stream: its first token and where its tokens come
// from (kSameTag + the same-run value, or the literal offset: token i of
// the run is syms[clamp(info + i)]).
struct Run {
  long long start, info;
};

struct RunSum {
  long long len, lit;
  int same;
};

// The escape parse's map of a span: incoming marker bit b -> (out[b],
// token starts cnt[b]).
struct Fn {
  int out0, cnt0, out1, cnt1;
};

__device__ __forceinline__ RunSum add(const RunSum& a, const RunSum& b) {
  return {a.len + b.len, a.lit + b.lit, a.same + b.same};
}

__device__ __forceinline__ Fn compose(const Fn& a, const Fn& b) {  // a, then b
  return {a.out0 ? b.out1 : b.out0, a.cnt0 + (a.out0 ? b.cnt1 : b.cnt0),
          a.out1 ? b.out1 : b.out0, a.cnt1 + (a.out1 ? b.cnt1 : b.cnt0)};
}

struct AddOp {
  __device__ RunSum operator()(const RunSum& a, const RunSum& b) const { return add(a, b); }
};
struct ComposeOp {
  __device__ Fn operator()(const Fn& a, const Fn& b) const { return compose(a, b); }
};

// Exclusive scan of one value a thread, in thread order (Hillis-Steele
// over buf); *total gets the whole block's.  Every thread calls it.
template <class T, class Op>
__device__ T block_exclusive_scan(T x, T identity, Op op, T* buf, T* total) {
  const int t = threadIdx.x;
  buf[t] = x;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    T y = buf[t];
    if (t >= off) y = op(buf[t - off], y);
    __syncthreads();
    buf[t] = y;
    __syncthreads();
  }
  const T ex = t > 0 ? buf[t - 1] : identity;
  *total = buf[kThreads - 1];
  __syncthreads();  // buf is free for the next scan
  return ex;
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ unsigned unzig(unsigned v) { return (v >> 1) ^ (0u - (v & 1u)); }

// A thread's contiguous span [lo, hi) of n items.
__device__ __forceinline__ void span_of(long long n, long long* lo, long long* hi) {
  const long long per = (n + kThreads - 1) / kThreads;
  *lo = per * threadIdx.x < n ? per * threadIdx.x : n;
  *hi = *lo + per < n ? *lo + per : n;
}

// The expanded token at nondecreasing positions: seek() once, then at().
struct Walk {
  const uint16_t* syms;
  long long cols;
  const Run* runs;
  int n_valid;  // runs that count: min(max(n_runs, 0), max_runs)
  long long n_tok;
  int rid;

  // The last run whose start is <= i (run 0 where none is): the twin's
  // branch-free binary search, whose predicate is monotone here.
  __device__ void seek(long long i) {
    int lo = 0;
    if (n_valid > 0)
      for (int step = 1 << (31 - __clz(n_valid)); step; step >>= 1)
        if (lo + step <= n_valid && runs[lo + step - 1].start <= i) lo += step;
    rid = lo > 0 ? lo - 1 : 0;
  }

  __device__ unsigned at(long long i) {
    if (i >= n_tok) return 0;
    while (rid + 1 < n_valid && runs[rid + 1].start <= i) ++rid;
    const long long info = runs[rid].info;
    if (info >= kSameTag) return (unsigned)(info - kSameTag);
    return syms[clampll(info + i, 0, cols - 1)];
  }
};

// The strip's runs into its scratch; returns the expand's token count.
__device__ long long build_runs(const uint16_t* syms, long long cols, long long n_runs,
                                long long n_same, int mid, int max_runs, Run* runs,
                                RunSum* buf) {
  const int n_valid = (int)clampll(n_runs, 0, max_runs);
  long long r0, r1;
  span_of(n_valid, &r0, &r1);
  RunSum mine = {0, 0, 0};
  for (long long r = r0; r < r1; ++r) {
    const int c = syms[r < cols ? r : cols - 1];
    const bool same = c <= mid;
    const long long len = same ? c : c - mid;
    mine.len += len;
    mine.lit += same ? 0 : len;
    mine.same += same;
  }
  RunSum total;
  const RunSum pre = block_exclusive_scan(mine, RunSum{0, 0, 0}, AddOp(), buf, &total);
  const long long lit_base = n_runs + n_same;
  long long out_start = pre.len, lit_start = pre.lit;
  long long same_rank = pre.same;
  for (long long r = r0; r < r1; ++r) {
    const int c = syms[r < cols ? r : cols - 1];
    const bool same = c <= mid;
    const long long len = same ? c : c - mid;
    long long info;
    if (same) {
      info = kSameTag + syms[clampll(n_runs + same_rank, 0, cols - 1)];
      ++same_rank;
    } else {
      info = lit_base + lit_start - out_start;
      lit_start += len;
    }
    runs[r] = Run{out_start, info};
    out_start += len;
  }
  __syncthreads();  // the runs, for every thread's walk
  return total.len;
}

// Row prefix of the unzigzagged symbols, mod 2^16, a warp a row (zzd,
// pdd's first pass).  src holds src_len symbols (0 past them).
__device__ void row_prefix(const uint16_t* src, long long src_len, uint16_t* dst, int w, int h) {
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < h; y += kWarps) {
    unsigned carry = 0;
    const long long base = (long long)y * w;
    for (int x0 = 0; x0 < w; x0 += 32) {
      const int x = x0 + lane;
      const long long p = base + x;
      unsigned a = unzig(x < w && p < src_len ? src[p] : 0u);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned u = __shfl_up_sync(kFull, a, off);
        if (lane >= off) a += u;
      }
      a += carry;
      if (x < w) dst[p] = (uint16_t)a;
      carry = __shfl_sync(kFull, a, 31);
    }
  }
}

// Column prefix, mod 2^16, a thread a column (vdd with unzigzag, pdd's
// second pass without).
__device__ void col_prefix(const uint16_t* src, long long src_len, uint16_t* dst, int w, int h,
                           bool unzigzag) {
  for (int c = threadIdx.x; c < w; c += kThreads) {
    unsigned acc = 0;
#pragma unroll 4
    for (int y = 0; y < h; ++y) {
      const long long p = (long long)y * w + c;
      const unsigned v = p < src_len ? src[p] : 0u;
      acc += unzigzag ? unzig(v) : v;
      dst[p] = (uint16_t)acc;
    }
  }
}

// The direct inverses (pred kZzd / kVdd / kPdd).
__device__ void direct_inverse(int pred, const uint16_t* src, long long src_len, uint16_t* dst,
                               int w, int h) {
  if (pred == kVdd) {
    col_prefix(src, src_len, dst, w, h, true);
    return;
  }
  row_prefix(src, src_len, dst, w, h);
  if (pred == kPdd) {
    __syncthreads();
    col_prefix(dst, (long long)w * h, dst, w, h, false);
  }
}

// zz: the left-delta inverse, restarting at each raw pixel, a warp a row;
// a segmented prefix over (raw flag, raw ? value : unzigzag(value)).
__device__ void zz_rows(uint16_t* o, const uint8_t* fl, int w, int h) {
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < h; y += kWarps) {
    unsigned carry = 0;
    const long long base = (long long)y * w;
    for (int x0 = 0; x0 < w; x0 += 32) {
      const int x = x0 + lane;
      const long long p = base + x;
      const unsigned v = x < w ? o[p] : 0u;
      unsigned f = x < w ? fl[p] : 0u;
      unsigned a = f ? v : unzig(v);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned ua = __shfl_up_sync(kFull, a, off);
        const unsigned uf = __shfl_up_sync(kFull, f, off);
        if (lane >= off) {
          if (!f) a += ua;
          f |= uf;
        }
      }
      const unsigned res = f ? a : carry + a;
      if (x < w) o[p] = (uint16_t)res;
      carry = __shfl_sync(kFull, res, 31);
    }
  }
}

// avg: the avg(left, top) inverse along wavefronts k = 2i + j.
__device__ void avg_rows(uint16_t* o, const uint8_t* fl, int w, int h, int thr, uint16_t* ring) {
  const int K = 2 * (h - 1) + w;
  for (int k = 0; k < K; ++k) {
    uint16_t* cur = ring + (k & 3) * h;
    const uint16_t* prev = ring + ((k + 3) & 3) * h;   // step k - 1
    const uint16_t* prev2 = ring + ((k + 2) & 3) * h;  // step k - 2
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const int j = k - 2 * i;
      if (j < 0 || j >= w) continue;
      const long long p = (long long)i * w + j;
      const int v = o[p];
      int val = v;
      if (!fl[p]) {
        int pred;
        if (i == 0) {
          pred = j == 0 ? 0 : prev[i];
        } else {
          const int top = prev2[i - 1];
          pred = j == 0 ? top : (prev[i] + top) >> 1;
        }
        val = (pred + v - thr) & 0xFFFF;
      }
      cur[i] = (uint16_t)val;
      o[p] = (uint16_t)val;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
post_groups_kernel(const Group* __restrict__ groups, const int2* __restrict__ blocks,
                   const __grid_constant__ Ents ents, uint16_t* out, Run* runs, uint8_t* flags) {
  __shared__ RunSum run_buf[kThreads];
  __shared__ Fn fn_buf[kThreads];
  __shared__ unsigned s_first[2];
  extern __shared__ uint16_t ring[];

  const int2 b = blocks[blockIdx.x];
  const Group g = groups[b.x];
  const int s = b.y;
  const long long cols = ents.cols[b.x];
  const uint16_t* __restrict__ syms = ents.p[b.x] + (size_t)s * (size_t)cols;
  const int w = g.width, h = g.strip_h;
  const long long need = (long long)w * h;
  uint16_t* o = out + g.out_off + (size_t)s * (size_t)need;

  if (g.pred <= kPdd) {
    direct_inverse(g.pred, syms, cols, o, w, h);
    return;
  }

  const long long* m = g.meta + 3LL * s;
  const long long n_tokens = m[0], n_runs = m[1], n_same = m[2];
  Run* rr = runs + g.runs_off + (size_t)s * (size_t)g.max_runs;
  Walk wk = {syms, cols, rr, (int)clampll(n_runs, 0, g.max_runs), 0, 0};
  wk.n_tok = build_runs(syms, cols, n_runs, n_same, g.mid, g.max_runs, rr, run_buf);

  if (g.pred <= kPdr) {  // zzr / vdr / pdr: tokens[:need] (0 past max_tokens), then inverse
    long long i0, i1;
    span_of(need, &i0, &i1);
    if (i0 < i1) wk.seek(i0);
    for (long long i = i0; i < i1; ++i) o[i] = (uint16_t)(i < g.max_tokens ? wk.at(i) : 0u);
    __syncthreads();
    direct_inverse(g.pred - kZzr, o, need, o, w, h);
    return;
  }

  // zz / avg: the escape parse of tokens[1:], n_tokens - 1 of them valid.
  uint8_t* fl = flags + g.flags_off + (size_t)s * (size_t)need;
  const int mp = g.max_tokens - 1;  // tokens[1:]'s length
  const long long n = n_tokens - 1;
  const int delim = g.delim;
  long long j0, j1;
  span_of(clampll(n, 0, mp), &j0, &j1);
  Fn mine = {0, 0, 1, 0};
  if (j0 < j1) {
    wk.seek(j0 + 1);
    int m0 = 0, m1 = 1, c0 = 0, c1 = 0;
    for (long long j = j0; j < j1; ++j) {
      const bool d = wk.at(j + 1) == (unsigned)delim;
      c0 += !m0;
      m0 = d && !m0;
      c1 += !m1;
      m1 = d && !m1;
    }
    mine = {m0, c0, m1, c1};
  }
  Fn total;
  const Fn pre = block_exclusive_scan(mine, Fn{0, 0, 1, 0}, ComposeOp(), fn_buf, &total);
  long long rank = pre.cnt0;
  if (j0 < j1 && rank < need) {
    bool mk = pre.out0;
    wk.seek(j0 + 1);
    unsigned tc = wk.at(j0 + 1);
    for (long long j = j0; j < j1; ++j) {
      const unsigned tn = wk.at((j + 1 < mp ? j + 1 : mp - 1) + 1);  // the next token, clipped
      const bool ts = !mk;
      const bool mark = ts && tc == (unsigned)delim;
      if (ts) {
        o[rank] = (uint16_t)(mark ? tn : tc);
        fl[rank] = mark;
        if (++rank >= need) break;
      }
      mk = mark;
      tc = tn;
    }
  }
  if (total.cnt0 < need) {  // the rest take position 0's pixel
    if (threadIdx.x == 0) {
      wk.seek(1);
      const unsigned t0 = wk.at(1);
      const unsigned t1 = wk.at((mp > 1 ? 1 : 0) + 1);
      const bool mark0 = n > 0 && t0 == (unsigned)delim;
      s_first[0] = mark0 ? t1 : t0;
      s_first[1] = mark0;
    }
    __syncthreads();
    for (long long r = total.cnt0 + threadIdx.x; r < need; r += kThreads) {
      o[r] = (uint16_t)s_first[0];
      fl[r] = (uint8_t)s_first[1];
    }
  }
  __syncthreads();
  if (g.pred == kZz)
    zz_rows(o, fl, w, h);
  else
    avg_rows(o, fl, w, h, g.delim >> 1, ring);
}

}  // namespace

extern "C" {

// One launch over n_groups buckets: groups (Group[n_groups]) and blocks
// (int2 [n_blocks]: group, strip) on the device; ents and cols host
// arrays of n_groups entropy outputs (int16 [S, cols], contiguous) and
// their column counts; out the flat output buffer the groups' out_off
// index; runs and flags the scratch; smem_bytes the avg ring's dynamic
// shared memory.  Returns cudaErrorInvalidValue for sizes the kernel
// does not take, else the launch's error (cudaGetLastError()).
int mic_post_groups(const void* groups, const void* blocks, int n_blocks,
                    const void* const* ents, const int* cols, int n_groups, void* out,
                    void* runs, void* flags, int smem_bytes, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || n_blocks < 1 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  Ents e = {};
  for (int i = 0; i < n_groups; ++i) {
    e.p[i] = (const uint16_t*)ents[i];
    e.cols[i] = cols[i];
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        post_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  post_groups_kernel<<<n_blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const Group*)groups, (const int2*)blocks, e, (uint16_t*)out, (Run*)runs,
      (uint8_t*)flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
