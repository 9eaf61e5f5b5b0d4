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
//   avg_i            the reference formats' strips (a PICS strip, a
//                    single-frame blob): the symbols are the Init word
//                    and an interleaved RLE stream (a count <= mid and a
//                    value, or a count > mid and count - mid literals,
//                    ops/rle.py), whose run headers are found here; then
//                    the escape parse and the avg inverse as for avg.
//                    The strip's mid comes from its Init word and its
//                    delim from token 0 (deltarle.py's reading), so each
//                    strip has its own (post.py: _interleaved_avg).
// Every clamp of the twin holds, so damaged streams give its output bit
// for bit: gathers clipped to the stream, tokens past the expand's count
// 0, a pixel past the count of token starts takes position 0's value,
// outputs masked to 16 bits.
//
// What bounds it on this card.  The bytes are the symbols in and the
// pixels out (phase 6 of chip_smoke.py: ~72 M pixels, near 0.1 ms at
// 3.35 TB/s).  Against them stand a strip's serial chains (the escape
// parse's marker recurrence, the avg recurrence's (h - 1) + w / 8 steps)
// and the latency of a block's loads: this kernel's first form had a
// thread walk a contiguous span of ~257 tokens, so every warp load or
// store touched 32 lines, at 48 registers and 5 blocks an SM.  Here a warp
// works on 32 neighbouring positions at every instruction, a thread
// issues its independent loads together, and 4 blocks of 64 registers
// share an SM (scripts/post_design_points.py times the other forms); the
// expand and the parse, about 3/4 of phase 6's launch, issue ~100 warp
// instructions a word of 32 tokens (locating each token's run, the word's
// ballots and map, the ranked store):
//
// 1. A block per strip, kThreads threads; the blocks of avg strips come
//    first in the launch (their chains are the longest), then zz, then
//    the rest (post.py: PostPacking orders them).
// 2. The runs: a thread a run, kThreads runs a round, a warp-shuffle scan
//    of the lengths and one shared-memory pass across the warps give each
//    run its first token and its token source (a same-run value, or the
//    offset of its literals in the stream), in shared memory (up to
//    kRunsSmem runs a strip; more go to the device scratch).
// 3. A token: each thread keeps a cursor into the runs that only moves
//    forward, since the positions a thread asks for never decrease (the
//    last run whose start is <= a position is the twin's binary-search
//    answer; zero-length runs and runs on one start resolve to the last of
//    them).  A thread locates several tokens, then issues their literal
//    reads together: 32 neighbouring symbols a warp each.
// 4. The escape parse, kWords words of 32 positions a warp, kChunk
//    positions a chunk.  A ballot gives a word's delim bits; the marker
//    recurrence m[j] = delim[j] && !m[j - 1] is resolved in the word from
//    the parity of the delim run ending at j, for both values of the bit
//    that comes in (a word without delims skips it); the words' maps
//    (incoming bit -> outgoing bit, token starts) are composed over a
//    warp's words, and one shared-memory pass across the warps gives each
//    warp its incoming bit and rank and the chunk its carry.  The token
//    starts' ranks are popcounts, so neighbouring token starts store their
//    pixels (the next token for a marker) at neighbouring ranks of the
//    strip's output row; the raw flags are a bit a pixel in shared memory
//    (device scratch past kFlagBits pixels).  Ranks past the count of
//    token starts take position 0's pixel and flag, as the twin's zeroed
//    scatter gives.
// 5. The inverses, in place on the output row.  The row prefix (zzd, pdd's
//    first pass, zz's segmented form restarting at every raw pixel) a warp
//    a row, 4 neighbouring pixels a lane, one shuffle ladder a 128-pixel
//    round, the next round's loads in flight; the column prefix (vdd, pdd's
//    second pass) a thread a column, 8 rows' loads at once.  avg a thread a
//    row, bands of kThreads rows: at step K row i takes its 8 columns of
//    block K - i, left from its own last value, top (row i - 1's block of
//    the step before) by shuffles from the lane below, for a warp's first
//    row from the upper warp's ring, one barrier a step; a window of
//    kAvgWin steps loads the row's columns as 16-byte loads where the rows
//    are aligned (8 two-byte loads where not), the next window's in flight,
//    with their 32 flag bits by a funnel shift.
//
// avg_i's front end: warp 0 walks the headers from word 0, a window of 32
// words a load: each lane computes its word's next header (q + 2 after a
// same-run count, q + 1 + count - mid after a literal one, clamped to the
// last word, where a fixed point ends the walk), the walk hops through the
// window by shuffles and loads the next window where a hop leaves it.  A
// PICS-8 CT strip has 27-145 runs, its literal runs thousands of words
// long, so a strip costs about one dependent load a literal run.  The
// header positions go to the runs' start array, then a thread a run turns
// them into (first token, source) with one scan of the lengths, and the
// token location, the parse and the avg inverse run as for avg.  The
// kernel is a template: post_groups_kernel<true> holds this front end and
// takes the launches with an avg_i bucket, post_groups_kernel<false>,
// MICW's routes alone, is the kernel as it was without it.
//
// Shared memory, static: the runs (12 bytes a run) or the avg rings, the
// flag bits, the scans' warp totals.  Device scratch, made by the wrapper:
// the runs of strips past kRunsSmem runs (16 bytes a run of max_runs a
// strip) and the flag bits of strips past kFlagBits pixels.  An avg_i
// bucket's runs scratch is not a strip's but a slot's: the walk finds a
// strip's header count only as it goes, so where it passes kRunsSmem the
// block claims one of Slots' n slots (the blocks of the instance resident
// on the card at once) and frees it once its parse has read the runs; a
// holder waits on nothing, so a claim always ends.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

// Forms for scripts/post_design_points.py.  MIC_POST_STAGE: 0 the runs
// only (no output), 1 through the expand and the parse (the parsed
// values, or the symbols / tokens of the direct and r-modes, no inverse),
// 2 everything, 3 everything but the expand and the parse (the inverses
// on whatever the output rows hold: a time, not an output).
// MIC_POST_WORDS: words a warp takes a chunk of the parse (and tokens a
// thread a round of the r-modes' expand).  MIC_POST_RUNS_SMEM /
// MIC_POST_FLAG_BITS: the most runs / pixels of a strip whose runs / flag
// bits stay in shared memory (0: device scratch always).
// MIC_POST_MIN_BLOCKS: __launch_bounds__' blocks an SM.  MIC_POST_AVG_WIN:
// avg steps a window.
#ifndef MIC_POST_STAGE
#define MIC_POST_STAGE 2
#endif
#ifndef MIC_POST_WORDS
#define MIC_POST_WORDS 8
#endif
#ifndef MIC_POST_RUNS_SMEM
#define MIC_POST_RUNS_SMEM 1024
#endif
#ifndef MIC_POST_FLAG_BITS
#define MIC_POST_FLAG_BITS 65536
#endif
#ifndef MIC_POST_MIN_BLOCKS
#define MIC_POST_MIN_BLOCKS 4
#endif
#ifndef MIC_POST_AVG_WIN
#define MIC_POST_AVG_WIN 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 128;           // buckets a launch (post.py: MAX_GROUPS)
constexpr long long kSameTag = 1LL << 62;  // a run's source for a same-run: kSameTag + value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
constexpr int kWords = MIC_POST_WORDS;
constexpr int kChunk = kThreads * kWords;  // parse positions a chunk
constexpr int kRunsSmem = MIC_POST_RUNS_SMEM;
constexpr int kFlagBits = MIC_POST_FLAG_BITS;
constexpr int kAvgWin = MIC_POST_AVG_WIN;  // avg steps a window (8 columns a step)
constexpr int kAvgBytes = kWarps * 2 * 16;  // the warps' rings: two steps of 8 pixels
constexpr int kRunsBytes = kRunsSmem * 12;
constexpr int kPoolBytes = kRunsBytes > kAvgBytes ? kRunsBytes : kAvgBytes;

// post.py: ROUTES
enum Pred { kZzd = 0, kVdd, kPdd, kZzr, kVdr, kPdr, kZz, kAvg, kAvgI };

// One bucket's post stage (post.py: _GROUP_DESC, 64 bytes).
struct Group {
  const long long* meta;  // [S, 3]: n_tokens, n_runs, n_same (the table entries)
  long long out_off;      // its output's first element in out
  long long runs_off;     // its first run in the runs scratch (max_runs a strip)
  long long flags_off;    // its first word in the flags scratch (zz / avg: a bit a pixel)
  int width, strip_h, max_runs, max_tokens, mid, delim, pred, pad;
};

// One launch's entropy outputs: int16 [S, cols] each, contiguous.
struct Ents {
  const uint16_t* p[kMaxGroups];
  int cols[kMaxGroups];
};

// avg_i's runs-scratch slots: busy[i] is 1 while a block holds slot i, 0
// before and after every launch (post.py: PostPacking.slots, .busy).
struct Slots {
  int* busy;
  int n;
};

// The escape parse's map of a stretch of positions: incoming marker bit
// b -> (out[b], token starts cnt[b]).
struct Fn {
  int out0, cnt0, out1, cnt1;
};

__device__ __forceinline__ Fn compose(const Fn& a, const Fn& b) {  // a, then b
  return {a.out0 ? b.out1 : b.out0, a.cnt0 + (a.out0 ? b.cnt1 : b.cnt0),
          a.out1 ? b.out1 : b.out0, a.cnt1 + (a.out1 ? b.cnt1 : b.cnt0)};
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ unsigned unzig(unsigned v) { return (v >> 1) ^ (0u - (v & 1u)); }

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// The first n lanes of a word (n may be <= 0 or > 32).
__device__ __forceinline__ unsigned first_lanes(int n) {
  return n <= 0 ? 0u : (n >= 32 ? kFull : lanes_below(n));
}

// The expanded token at positions that never decrease for the calling
// thread.  A run has its first token (clamped to kIntMax, which no
// position reaches) and its source (kSameTag + value, or the literal
// offset: token i of the run is syms[clamp(source + i)]).
struct Tokens {
  const uint16_t* syms;
  long long cols;
  const int* start;
  const long long* source;
  int n_valid;  // runs that count: min(max(n_runs, 0), max_runs)
  long long n_tok;
  int rid;

  // Token i without its load: the symbol to read (>= 0), or -1 with *v
  // the token (a same-run value, or 0 past the expand's count).  Callers
  // locate several tokens, then issue their loads together.
  __device__ int locate(long long i, unsigned* v) {
    *v = 0;
    if (i >= n_tok) return -1;
    while (rid + 1 < n_valid && start[rid + 1] <= i) ++rid;
    const long long src = source[rid];
    if (src >= kSameTag) {
      *v = (unsigned)(src - kSameTag);
      return -1;
    }
    return (int)clampll(src + i, 0, cols - 1);
  }

  __device__ unsigned at(long long i) {
    unsigned v;
    const int k = locate(i, &v);
    return k < 0 ? v : syms[k];
  }
};

// The strip's runs into start / source, a thread a run; returns the
// expand's token count.  wsum: 4 * kWarps values of shared memory.
__device__ long long build_runs(const uint16_t* syms, long long cols, long long n_runs,
                                long long n_same, int mid, int n_valid, int* start,
                                long long* source, long long* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lit_base = n_runs + n_same;
  long long len_carry = 0, same_len_carry = 0, same_carry = 0;
  for (int r0 = 0, round = 0; r0 < n_valid; r0 += kThreads, ++round) {
    const int r = r0 + threadIdx.x;
    long long len = 0, sp = 0;  // sp: a same-run's length + 1 << 32 (a round's sums fit)
    bool same = false;
    if (r < n_valid) {
      const int c = syms[r < cols ? r : cols - 1];
      same = c <= mid;
      len = same ? c : (long long)c - mid;
      sp = same ? c + (1LL << 32) : 0;
    }
    long long a = len, b = sp;  // inclusive warp scans
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long ua = __shfl_up_sync(kFull, a, off), ub = __shfl_up_sync(kFull, b, off);
      if (lane >= off) {
        a += ua;
        b += ub;
      }
    }
    long long* buf = wsum + (round & 1) * 2 * kWarps;  // two rounds' buffers: one barrier a round
    if (lane == 31) {
      buf[warp] = a;
      buf[kWarps + warp] = b;
    }
    __syncthreads();
    long long pa = 0, pb = 0, ta = 0, tb = 0;
    for (int v = 0; v < kWarps; ++v) {
      const long long xa = buf[v], xb = buf[kWarps + v];
      if (v < warp) {
        pa += xa;
        pb += xb;
      }
      ta += xa;
      tb += xb;
    }
    if (r < n_valid) {
      const long long first = len_carry + pa + a - len;
      const long long ex = pb + b - sp;  // this round's same-runs before r
      start[r] = first < kIntMax ? (int)first : kIntMax;
      source[r] = same ? kSameTag + syms[clampll(n_runs + same_carry + (ex >> 32), 0, cols - 1)]
                       : lit_base - (same_len_carry + (ex & 0xffffffffLL));
    }
    len_carry += ta;
    same_len_carry += tb & 0xffffffffLL;
    same_carry += tb >> 32;
  }
  __syncthreads();  // the runs, for every thread's cursor
  return len_carry;
}

__device__ __forceinline__ unsigned flag_at(const unsigned* fw, long long p) {
  return (fw[p >> 5] >> (p & 31)) & 1u;
}

// The row prefix, mod 2^16, a warp a row, kPer neighbouring pixels a lane
// (32 * kPer a round): each lane sums its pixels, one shuffle ladder over
// the lanes' sums gives each lane its carry in.  Without kRaw (zzd, pdd's
// first pass) over the unzigzagged symbols (src_len of them, 0 past);
// with kRaw (zz) a segmented prefix over (raw flag, raw ? value :
// unzigzag(value)) that restarts at every raw pixel (fw: the flag bits).
template <bool kRaw>
__device__ void row_scan(const uint16_t* src, long long src_len, uint16_t* dst,
                         const unsigned* fw, int w, int h) {
  constexpr int kPer = 4;
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < h; y += kWarps) {
    const long long base = (long long)y * w;
    unsigned carry = 0, v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = kPer * lane + i;
      v[i] = x < w && base + x < src_len ? src[base + x] : 0u;
    }
    for (int x0 = 0; x0 < w; x0 += 32 * kPer) {
      const int xl = x0 + kPer * lane;
      unsigned a[kPer], acc = 0, seen = 0, raw_before = 0;  // raw_before: bit i, a raw pixel <= i
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool raw = kRaw && xl + i < w && flag_at(fw, base + xl + i);
        acc = raw ? v[i] : acc + unzig(v[i]);
        seen |= raw;
        raw_before |= seen << i;
        a[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {  // the next round's, in flight during the ladder
        const int x = xl + 32 * kPer + i;
        v[i] = x < w && base + x < src_len ? src[base + x] : 0u;
      }
      unsigned sum = acc, fixed = seen;  // inclusive over the lanes; fixed: sum is absolute
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned us = __shfl_up_sync(kFull, sum, off);
        const unsigned uf = __shfl_up_sync(kFull, fixed, off);
        if (lane >= off) {
          if (!fixed) sum += us;
          fixed |= uf;
        }
      }
      const unsigned ps = __shfl_up_sync(kFull, sum, 1), pf = __shfl_up_sync(kFull, fixed, 1);
      const unsigned in = lane == 0 ? carry : (pf ? ps : carry + ps);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (xl + i < w) dst[base + xl + i] = (uint16_t)((raw_before >> i) & 1u ? a[i] : in + a[i]);
      carry = __shfl_sync(kFull, fixed ? sum : carry + sum, 31);
    }
  }
}

// Column prefix, mod 2^16, a thread a column (vdd with unzigzag, pdd's
// second pass without).
__device__ void col_prefix(const uint16_t* src, long long src_len, uint16_t* dst, int w, int h,
                           bool unzigzag) {
  for (int c = threadIdx.x; c < w; c += kThreads) {
    unsigned acc = 0;
    for (int y0 = 0; y0 < h; y0 += 8) {  // 8 rows' loads in flight, then their sums
      unsigned v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long p = (long long)(y0 + i) * w + c;
        v[i] = y0 + i < h && p < src_len ? src[p] : 0u;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (y0 + i >= h) break;
        acc += unzigzag ? unzig(v[i]) : v[i];
        dst[(long long)(y0 + i) * w + c] = (uint16_t)acc;
      }
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
  row_scan<false>(src, src_len, dst, nullptr, w, h);
  if (pred == kPdd) {
    __syncthreads();
    col_prefix(dst, (long long)w * h, dst, w, h, false);
  }
}

// The marker bit of `lane` in a word whose delim bits are D, the bit
// before the word being c: 1 at the even offsets of each delim run from
// its first lane; for the run that starts the word, m[0] = !c, alternating.
__device__ __forceinline__ unsigned marker_bit(unsigned D, int lane, unsigned c) {
  if (!((D >> lane) & 1u)) return 0;
  const unsigned below = ~D & lanes_below(lane);
  if (below) return ((lane - (32 - __clz((int)below))) & 1) ^ 1u;
  return ((unsigned)lane & 1u) ^ 1u ^ c;
}

// The escape parse of tokens[1:] (n of them valid, mp in all) into o's
// first `need` pixels and their raw bits fw (zeroed); every thread of the
// block calls it.  s_fn: 2 * kWarps maps of shared memory.
__device__ void parse(Tokens tk, int mp, long long n, int delim, long long need, uint16_t* o,
                      unsigned* fw, Fn* s_fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_par = (int)clampll(n, 0, mp);
  unsigned mk = 0;     // the marker bit before the chunk
  long long rank = 0;  // token starts before the chunk
  for (int c0 = 0, chunk = 0; c0 < n_par && rank < need; c0 += kChunk, ++chunk) {
    const int seg = c0 + warp * 32 * kWords;  // this warp's positions of the chunk
    unsigned t[kWords], m0[kWords], m1[kWords], extra = 0;
    int at[kWords], at_x = -1;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {  // tokens[1:][j] (a valid one's next too)
      const int j = seg + 32 * k + lane;
      at[k] = j < mp && j <= n_par ? tk.locate(j + 1, &t[k]) : (t[k] = 0, -1);
    }
    const int jx = seg + 32 * kWords;  // lane 31's next: the token after the warp's last word
    if (lane == 31 && jx < mp && jx <= n_par) at_x = tk.locate(jx + 1, &extra);
#pragma unroll
    for (int k = 0; k < kWords; ++k)  // the literal reads, all in flight
      if (at[k] >= 0) t[k] = tk.syms[at[k]];
    if (at_x >= 0) extra = tk.syms[at_x];
    Fn f = {0, 0, 1, 0};
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int j = seg + 32 * k + lane;
      const unsigned D = __ballot_sync(kFull, j < n_par && t[k] == (unsigned)delim);
      m0[k] = m1[k] = 0;
      if (D) {  // the marker recurrence (most words hold no delim)
        m0[k] = __ballot_sync(kFull, marker_bit(D, lane, 0));
        const unsigned nd = ~D;
        m1[k] = m0[k] ^ ((nd & (0u - nd)) - 1u);  // flipped on the delim run that starts the word
      }
      const unsigned V = first_lanes(n_par - (seg + 32 * k));
      f = compose(f, Fn{(int)(m0[k] >> 31), __popc(V & ~(m0[k] << 1)), (int)(m1[k] >> 31),
                        __popc(V & ~((m1[k] << 1) | 1u))});
    }
    Fn* buf = s_fn + (chunk & 1) * kWarps;  // two chunks' buffers: one barrier a chunk
    if (lane == 0) buf[warp] = f;
    __syncthreads();
    unsigned c = mk, cin = 0;
    long long rb = rank, rin = 0;
    for (int v = 0; v < kWarps; ++v) {
      if (v == warp) {  // this warp's carry in
        cin = c;
        rin = rb;
      }
      const Fn g = buf[v];
      rb += c ? g.cnt1 : g.cnt0;
      c = c ? g.out1 : g.out0;
    }
    mk = c;  // the chunk's carry out
    rank = rb;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int j = seg + 32 * k + lane;
      const unsigned M = cin ? m1[k] : m0[k];
      const unsigned TS = first_lanes(n_par - (seg + 32 * k)) & ~((M << 1) | cin);
      const long long r = rin + __popc(TS & lanes_below(lane));
      const bool store = ((TS >> lane) & 1u) && r < need;
      if (m0[k] | m1[k]) {  // markers: their pixel is the next token
        // lane l takes lane l + 1's token, lane 31 the next word's first (or extra)
        const unsigned give = lane == 0 && k + 1 < kWords ? t[k + 1 < kWords ? k + 1 : k] : t[k];
        unsigned nxt = __shfl_sync(kFull, give, (lane + 1) & 31);
        if (lane == 31 && k + 1 == kWords) nxt = extra;
        if (j + 1 >= mp) nxt = t[k];  // the next token, clipped to tokens[1:]'s last
        const unsigned mark = (M >> lane) & 1u;
        if (store) {
          o[r] = (uint16_t)(mark ? nxt : t[k]);
          if (mark) atomicOr(&fw[r >> 5], 1u << (r & 31));
        }
      } else if (store) {
        o[r] = (uint16_t)t[k];
      }
      rin += __popc(TS);
      cin = M >> 31;
    }
  }
  if (rank < need) {  // the rest take position 0's pixel
    tk.rid = 0;
    const unsigned t0 = tk.at(1);
    const unsigned t1 = tk.at((mp > 1 ? 1 : 0) + 1);
    const bool mark0 = n > 0 && t0 == (unsigned)delim;
    for (long long r = rank + threadIdx.x; r < need; r += kThreads) {
      o[r] = (uint16_t)(mark0 ? t1 : t0);
      if (mark0) atomicOr(&fw[r >> 5], 1u << (r & 31));
    }
  }
}

// Eight pixels of a row from column c (a multiple of 8), two a word, 0
// past w: one 16-byte access where the rows are 16-byte aligned, else
// eight.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int c, int w, bool aligned) {
  if (aligned) return *(const uint4*)(row + c);
  unsigned x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned lo = c + 2 * e < w ? row[c + 2 * e] : 0u;
    x[e] = lo | (c + 2 * e + 1 < w ? row[c + 2 * e + 1] : 0u) << 16;
  }
  return uint4{x[0], x[1], x[2], x[3]};
}

__device__ __forceinline__ void store8(uint16_t* row, int c, int w, bool aligned, uint4 v) {
  if (aligned) {
    *(uint4*)(row + c) = v;
    return;
  }
  const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < w) row[c + e] = (uint16_t)(x[e >> 1] >> (16 * (e & 1)));
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint4 shfl_up4(uint4 v) {
  return uint4{__shfl_up_sync(kFull, v.x, 1), __shfl_up_sync(kFull, v.y, 1),
               __shfl_up_sync(kFull, v.z, 1), __shfl_up_sync(kFull, v.w, 1)};
}

// avg: the avg(left, top) inverse, a thread a row, a band of kThreads rows
// at a time.  At step K a row i takes its block of 8 columns P = K - i, so
// a row's top (row i - 1, block P) came a step earlier: from the lane
// below by shuffles, for a warp's first row from the upper warp's ring
// (pool: kAvgBytes), one barrier a step; (h - 1) + w / 8 steps.  A window
// of kAvgWin steps loads the row's 8 * kAvgWin columns at once (the next
// window's in flight) and its flag bits, and stores them at its end.
__device__ void avg_rows(uint16_t* o, const unsigned* fw, int w, int h, int thr,
                         unsigned char* pool) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* ring = (uint4*)pool;  // [kWarps][2]: lane 31's block of the last two steps
  const long long n_words = ((long long)w * h + 31) >> 5;
  const bool aligned = (w & 7) == 0 && ((uintptr_t)o & 15) == 0;
  const int blocks = (w + 7) >> 3;
  for (int b0 = 0; b0 < h; b0 += kThreads) {
    const int hb = imin(kThreads, h - b0);
    const int steps = hb - 1 + blocks;
    const int rel = warp * 32 + lane;  // this lane's band row
    const bool mine = rel < hb;
    uint16_t* row = o + (long long)(b0 + rel) * w;
    const uint16_t* above = o + (long long)(b0 - 1) * w;  // the row above the band (b0 > 0)
    unsigned left = 0;                // the row's last value
    uint4 done = {0, 0, 0, 0}, cur[kAvgWin], nxt[kAvgWin];
#pragma unroll
    for (int s = 0; s < kAvgWin; ++s) {
      const int P = s - rel;
      nxt[s] = mine && P >= 0 && P < blocks ? load8(row, 8 * P, w, aligned) : uint4{0, 0, 0, 0};
    }
    for (int K0 = 0; K0 < steps; K0 += kAvgWin) {
      unsigned fl = 0;  // the window's raw bits, column 8 * (K0 - rel) on
#pragma unroll
      for (int s = 0; s < kAvgWin; ++s) {
        cur[s] = nxt[s];
        const int P = K0 + kAvgWin + s - rel;
        nxt[s] = mine && P >= 0 && P < blocks ? load8(row, 8 * P, w, aligned) : uint4{0, 0, 0, 0};
      }
      const int c0 = 8 * (K0 - rel), ca = c0 > 0 ? c0 : 0;
      if (mine && ca < w && ca < c0 + 8 * kAvgWin) {
        const long long pa = (long long)(b0 + rel) * w + ca, wa = pa >> 5;
        const unsigned hi = wa + 1 < n_words ? fw[wa + 1] : 0u;
        fl = __funnelshift_r(fw[wa], hi, (unsigned)(pa & 31)) << (ca - c0);
      }
#pragma unroll
      for (int s = 0; s < kAvgWin; ++s) {
        const int K = K0 + s, P = K - rel;
        if (K >= steps) break;
        uint4 top = shfl_up4(done);  // row above, block P, from the lane below
        if (lane == 0) {
          if (warp) top = ring[(warp - 1) * 2 + ((K - 1) & 1)];
          else if (b0 > 0 && P >= 0 && P < blocks) top = load8(above, 8 * P, w, aligned);
        }
        if (mine && P >= 0 && P < blocks) {
          unsigned out[4];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = 8 * P + e;
            const int v = (word_of(cur[s], e >> 1) >> (16 * (e & 1))) & 0xFFFF;
            unsigned val = 0;
            if (j < w) {
              if ((fl >> (8 * s + e)) & 1u) {
                val = (unsigned)v;
              } else {
                const int t = (word_of(top, e >> 1) >> (16 * (e & 1))) & 0xFFFF;
                int pred;
                if (b0 + rel == 0)
                  pred = j == 0 ? 0 : (int)left;
                else
                  pred = j == 0 ? t : ((int)left + t) >> 1;
                val = (unsigned)((pred + v - thr) & 0xFFFF);
              }
              left = val;
            }
            if (e & 1)
              out[e >> 1] |= val << 16;
            else
              out[e >> 1] = val;
          }
          done = uint4{out[0], out[1], out[2], out[3]};
          cur[s] = done;
        }
        if (lane == 31) ring[warp * 2 + (K & 1)] = done;
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < kAvgWin; ++s) {  // the window's results back to the row
        const int P = K0 + s - rel;
        if (mine && P >= 0 && P < blocks) store8(row, 8 * P, w, aligned, cur[s]);
      }
    }
    __syncthreads();  // the band's last row, for the next band's top
  }
}

// The raw flags of strip s of an escaped route, a bit a pixel, zeroed: in
// shared memory up to kFlagBits pixels, else in the flags scratch.
__device__ __forceinline__ unsigned* zeroed_flags(const Group& g, int s, long long need,
                                                  unsigned* s_flags, unsigned* flags) {
  unsigned* fw =
      need <= kFlagBits ? s_flags : flags + g.flags_off + (long long)s * ((need + 31) >> 5);
  for (long long i = threadIdx.x; i < (need + 31) >> 5; i += kThreads) fw[i] = 0;
  return fw;
}

// The bit length of v (0 for 0).
__device__ __forceinline__ int bit_length(unsigned v) { return v ? 32 - __clz((int)v) : 0; }

// avg_i: slot i of group g's runs scratch, (source, start) of max_runs
// runs each.
__device__ __forceinline__ long long* slot_runs(const Group& g, unsigned char* runs, int i) {
  return (long long*)(runs + 16 * (g.runs_off + (long long)i * g.max_runs));
}

// avg_i: a free slot, claimed from the block's own onwards.
__device__ int claim_slot(const Slots& sl) {
  for (int i = blockIdx.x % sl.n;; i = i + 1 < sl.n ? i + 1 : 0)
    if (atomicCAS(sl.busy + i, 0, 1) == 0) {
      __threadfence();
      return i;
    }
}

// avg_i: the run headers of the words r[q] = syms[1 + q], q < W, from q = 0
// while q < n_stream (post.py: rle_expand's pointer doubling reaches the
// same positions); warp 0 calls it.  Header k goes to s_hdr[k] below
// kRunsSmem, from there to the start array of the slot that lane 0 claims
// at header kRunsSmem and returns in *slot (-1 on every other lane, and
// where the strip has no more headers); at most max_runs are kept (the
// wrapper gives max_runs >= interleaved_runs(cols), which every row
// keeps under).  Returns the header count on every lane.
__device__ int walk_headers(const uint16_t* syms, int W, int n_stream, int mid, const Group& g,
                            const Slots& sl, unsigned char* runs, int* s_hdr, int* slot) {
  const int lane = threadIdx.x & 31, max_runs = g.max_runs;
  int p = 0, k = 0;
  int* g_hdr = nullptr;
  *slot = -1;
  while (p < n_stream && k < max_runs) {  // a window of 32 words from header p
    const int q = p + lane;
    const unsigned c = q < W ? syms[1 + q] : 0u;
    const long long nl = c <= (unsigned)mid ? (long long)q + 2 : (long long)q + 1 + (c - mid);
    const int nx = (int)(nl < W - 1 ? nl : W - 1);
    for (int d = 0;;) {  // warp-uniform: d and the next header come by shuffle
      const int h = p + d;
      if (lane == 0) {
        if (k < kRunsSmem) {
          s_hdr[k] = h;
        } else {
          if (k == kRunsSmem) {
            *slot = claim_slot(sl);
            g_hdr = (int*)(slot_runs(g, runs, *slot) + max_runs);
          }
          g_hdr[k] = h;
        }
      }
      ++k;
      const int next = (int)__shfl_sync(kFull, (unsigned)nx, d);
      if (next == h || next >= n_stream || k >= max_runs) {
        p = n_stream;
        break;
      }
      d = next - p;
      if (d >= 32) {
        p = next;
        break;
      }
    }
  }
  return k;
}

// avg_i: the n_valid headers in start[] into (first token, source), a
// thread a run: a same-run's source is kSameTag + r[q + 1], a literal
// run's the symbol index of its first literal less its first token (q +
// 2 - first); returns the expand's token count.  wsum: 2 * kWarps values.
__device__ long long build_runs_interleaved(const uint16_t* syms, long long cols, int mid,
                                            int n_valid, int* start, long long* source,
                                            long long* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int r0 = 0, round = 0; r0 < n_valid; r0 += kThreads, ++round) {
    const int r = r0 + threadIdx.x;
    long long len = 0, src = 0;
    if (r < n_valid) {
      const int q = start[r];
      const unsigned c = syms[1 + q];
      const bool same = c <= (unsigned)mid;
      len = same ? c : (long long)c - mid;
      src = same ? kSameTag + syms[clampll(q + 2, 0, cols - 1)] : (long long)q + 2;
    }
    long long a = len;  // inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long u = __shfl_up_sync(kFull, a, off);
      if (lane >= off) a += u;
    }
    long long* buf = wsum + (round & 1) * kWarps;  // two rounds' buffers: one barrier a round
    if (lane == 31) buf[warp] = a;
    __syncthreads();
    long long pa = 0, ta = 0;
    for (int v = 0; v < kWarps; ++v) {
      if (v < warp) pa += buf[v];
      ta += buf[v];
    }
    if (r < n_valid) {
      const long long first = carry + pa + a - len;
      start[r] = first < kIntMax ? (int)first : kIntMax;
      source[r] = src >= kSameTag ? src : src - first;
    }
    carry += ta;
  }
  __syncthreads();  // the runs, for every thread's cursor
  return carry;
}

// avg_i, one strip (every thread of the block): the headers, the runs (in
// shared memory up to kRunsSmem, else in a slot of the runs scratch, freed
// once the parse has read them), the strip's delim from token 0, the
// parse, the avg inverse.
__device__ void interleaved_avg(const Group& g, const Slots& sl, const uint16_t* syms,
                                long long cols, const long long* m, uint16_t* o, long long need,
                                unsigned* fw, unsigned char* runs, unsigned char* pool,
                                long long* s_sum, Fn* s_fn) {
  const int W = (int)(cols - 1);
  const int n_stream = (int)clampll(m[0] - 1, 0, W);
  const unsigned v0 = syms[0];
  const int mid = v0 ? (int)(1u << (bit_length(v0) - 1)) - 1 : 0;
  long long* source = (long long*)pool;
  int* start = (int*)(pool + 8 * kRunsSmem);
  int* s_n = (int*)(s_sum + 2 * kWarps);  // past build_runs_interleaved's buffers
  if (threadIdx.x < 32) {
    int slot;
    const int n = walk_headers(syms, W, n_stream, mid, g, sl, runs, start, &slot);
    if (threadIdx.x == 0) {
      s_n[0] = n;
      s_n[1] = slot;
    }
  }
  __syncthreads();
  const int n_valid = s_n[0], slot = s_n[1];
  if (n_valid > kRunsSmem) {  // the slot takes them all: the first kRunsSmem from shared
    long long* g_source = slot_runs(g, runs, slot);
    int* g_start = (int*)(g_source + g.max_runs);
    for (int i = threadIdx.x; i < kRunsSmem; i += kThreads) g_start[i] = start[i];
    __syncthreads();
    source = g_source;
    start = g_start;
  }
  const long long n_tok = build_runs_interleaved(syms, cols, mid, n_valid, start, source,
                                                 s_sum);
  int delim = 0;
  if (MIC_POST_STAGE != 0) {
    Tokens tk = {syms, cols, start, source, n_valid, n_tok, 0};
    Tokens first = tk;
    delim = (int)((1u << bit_length(first.at(0))) - 1u);
    if (MIC_POST_STAGE != 3) parse(tk, g.max_tokens - 1, n_tok - 1, delim, need, o, fw, s_fn);
  }
  __syncthreads();  // every thread is done with the runs
  if (slot >= 0 && threadIdx.x == 0) {
    __threadfence();
    atomicExch(sl.busy + slot, 0);
  }
  if (MIC_POST_STAGE <= 1) return;
  avg_rows(o, fw, g.width, g.strip_h, delim >> 1, pool);
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kThreads, MIC_POST_MIN_BLOCKS)
post_groups_kernel(const Group* __restrict__ groups, const int2* __restrict__ blocks,
                   const __grid_constant__ Ents ents, uint16_t* out, unsigned char* runs,
                   unsigned* flags, Slots sl) {
  __shared__ __align__(16) unsigned char s_pool[kPoolBytes];  // the runs, then avg's rings
  __shared__ unsigned s_flags[kFlagBits > 0 ? kFlagBits / 32 : 1];
  __shared__ long long s_sum[4 * kWarps];
  __shared__ Fn s_fn[2 * kWarps];

  const int2 b = blocks[blockIdx.x];
  const Group g = groups[b.x];
  const int s = b.y;
  const long long cols = ents.cols[b.x];
  const uint16_t* __restrict__ syms = ents.p[b.x] + (size_t)s * (size_t)cols;
  const int w = g.width, h = g.strip_h;
  const long long need = (long long)w * h;
  uint16_t* o = out + g.out_off + (size_t)s * (size_t)need;

  if (g.pred <= kPdd) {
    if (MIC_POST_STAGE == 0) return;
    if (MIC_POST_STAGE == 1) {
      for (long long i = threadIdx.x; i < need; i += kThreads) o[i] = i < cols ? syms[i] : 0;
      return;
    }
    direct_inverse(g.pred, syms, cols, o, w, h);
    return;
  }

  const long long* m = g.meta + 3LL * s;
  if (kInterleaved && g.pred == kAvgI) {
    unsigned* fw = zeroed_flags(g, s, need, s_flags, flags);
    interleaved_avg(g, sl, syms, cols, m, o, need, fw, runs, s_pool, s_sum, s_fn);
    return;
  }
  const long long n_tokens = m[0], n_runs = m[1], n_same = m[2];
  const int n_valid = (int)clampll(n_runs, 0, g.max_runs);
  long long* source = (long long*)s_pool;
  int* start = (int*)(s_pool + 8 * kRunsSmem);
  if (n_valid > kRunsSmem) {  // the scratch's strip: max_runs sources, then max_runs starts
    source = (long long*)(runs + 16 * (g.runs_off + (long long)s * g.max_runs));
    start = (int*)(source + g.max_runs);
  }
  unsigned* fw = g.pred >= kZz ? zeroed_flags(g, s, need, s_flags, flags) : nullptr;
  const long long n_tok = build_runs(syms, cols, n_runs, n_same, g.mid, n_valid, start, source,
                                     s_sum);
  if (MIC_POST_STAGE == 0) return;
  Tokens tk = {syms, cols, start, source, n_valid, n_tok, 0};

  if (g.pred <= kPdr) {  // zzr / vdr / pdr: tokens[:need] (0 past max_tokens), then inverse
    for (long long i0 = threadIdx.x; i0 < need && MIC_POST_STAGE != 3;
         i0 += (long long)kThreads * kWords) {
      unsigned v[kWords];
      int at[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {  // kWords tokens located, then their loads together
        const long long i = i0 + (long long)k * kThreads;
        at[k] = i < need && i < g.max_tokens ? tk.locate(i, &v[k]) : (v[k] = 0, -1);
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        if (at[k] >= 0) v[k] = syms[at[k]];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const long long i = i0 + (long long)k * kThreads;
        if (i < need) o[i] = (uint16_t)v[k];
      }
    }
    if (MIC_POST_STAGE == 1) return;
    __syncthreads();
    direct_inverse(g.pred - kZzr, o, need, o, w, h);
    return;
  }

  // zz / avg: the escape parse of tokens[1:], n_tokens - 1 of them valid.
  if (MIC_POST_STAGE != 3) parse(tk, g.max_tokens - 1, n_tokens - 1, g.delim, need, o, fw, s_fn);
  if (MIC_POST_STAGE == 1) return;
  __syncthreads();
  if (g.pred == kZz)
    row_scan<true>(o, need, o, fw, w, h);
  else
    avg_rows(o, fw, w, h, g.delim >> 1, s_pool);
}

// The launch of either instance.
int launch(bool interleaved, const void* groups, const void* blocks, int n_blocks,
           const void* const* ents, const int* cols, int n_groups, void* out, void* runs,
           void* flags, Slots sl, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || n_blocks < 1 || (interleaved && sl.n < 1))
    return (int)cudaErrorInvalidValue;
  Ents e = {};
  for (int i = 0; i < n_groups; ++i) {
    e.p[i] = (const uint16_t*)ents[i];
    e.cols[i] = cols[i];
  }
  const auto kernel = interleaved ? post_groups_kernel<true> : post_groups_kernel<false>;
  kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const Group*)groups, (const int2*)blocks, e, (uint16_t*)out, (unsigned char*)runs,
      (unsigned*)flags, sl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over n_groups buckets: groups (Group[n_groups]) and blocks
// (int2 [n_blocks]: group, strip) on the device; ents and cols host
// arrays of n_groups entropy outputs (int16 [S, cols], contiguous) and
// their column counts; out the flat output buffer the groups' out_off
// index; runs and flags the scratch.  Returns cudaErrorInvalidValue for
// sizes the kernel does not take, else the launch's error
// (cudaGetLastError()).  MICW's routes only.
int mic_post_groups(const void* groups, const void* blocks, int n_blocks,
                    const void* const* ents, const int* cols, int n_groups, void* out,
                    void* runs, void* flags, void* stream) {
  return launch(false, groups, blocks, n_blocks, ents, cols, n_groups, out, runs, flags,
                Slots{nullptr, 0}, stream);
}

// The same launch through the kernel's instance with the avg_i front end:
// every route, the reference formats' too.  busy (int [n_slots] on the
// device, zero) are the avg_i buckets' runs-scratch slots, n_slots >= 1;
// every launch leaves them zero.
int mic_post_groups_interleaved(const void* groups, const void* blocks, int n_blocks,
                                const void* const* ents, const int* cols, int n_groups,
                                void* out, void* runs, void* flags, void* busy, int n_slots,
                                void* stream) {
  return launch(true, groups, blocks, n_blocks, ents, cols, n_groups, out, runs, flags,
                Slots{(int*)busy, n_slots}, stream);
}

// The launch's shape (MICW's instance, or the interleaved one where
// interleaved is nonzero): out[0] shared bytes a block, out[1] blocks
// resident an SM, out[2] registers a thread.  Returns the first CUDA
// error, else cudaSuccess.
int mic_post_shape(int* out, int interleaved) {
  const auto kernel = interleaved ? post_groups_kernel<true> : post_groups_kernel<false>;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)fa.sharedSizeBytes;
  out[2] = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, kThreads, 0);
}

}  // extern "C"
