// Fused r-mode decode of MICW (zzr / vdr / pdr) for Hopper: rANS, SoA-RLE
// expand and the direct predictors' inverse in one kernel, and every
// r-mode bucket of a decode plan in one launch.
//
// rle_groups_kernel replaces both Pallas r-kernels, one 128-thread block
// per strip (thread = lane), the front end chosen per block:
//
// * mic_tpu/tpu/pallas_rans.py:_kernel_rle (wrapper rans_decode_pallas_rle):
//   the FF 57 packed-table front end;
// * pallas_rans.py:_kernel_rle_alias (wrapper rans_decode_pallas_rle_alias):
//   the FF 41 alias front end, escapes included;
//
// each followed by the three phases of pallas_rans.py:_expand_rle_phase:
//
// 1.   Entropy: steps x 128 symbols into the strip's u16 scratch row
//      (stream order = step-major).
// 1.5. Run tables from the counts section (the first nrun symbols), R =
//      maxr / 128 rows: exclusive block scans of run lengths, literal
//      lengths and same-flags, carried across rows; st1 = start<<1 |
//      is_same (kHuge past nrun), st2 = the same-run value syms[nrun +
//      rank] or the literal source offset nrun + nsame + lstart - start.
// 2.   Expand out_rows rows of 128 px: each pixel takes the run holding
//      its position t*128 + lane, the same value or the literal syms[st2 +
//      pos], then unzigzag and the zzr/pdr row prefix sum with its reset
//      every ws rows or the vdr previous-row carry (pdr's column prefix is
//      the caller's).
//
// What bounds it on this card: a strip is a chain of dependent work, not a
// stream of bytes (a strip moves ~128 KB of pixels and ~40 KB of words: the
// batch's bytes take tens of microseconds).  The chain before this design
// was steps entropy steps with one barrier and two 5-round shuffle ladders
// each, then out_rows expand rows, each with two binary searches of
// log2(W) dependent reads, a barrier (the literal count) and for zzr/pdr a
// block scan: ~1000 cycles a row, 512 rows.  Now a strip's chain is its
// entropy steps (~600 cycles each: two dependent table reads, a vote, a
// barrier, the ring read) plus 64 chunks of the expand, ~160 us at 256
// steps with an SM to itself; a plan's one launch of 1728 strips is bound
// by what the SMs issue (~9 blocks an SM; the expand's per-pixel work is
// most of it), ~0.56 ms, 6x the bytes bound.  The design, point by point
// (scripts/rle_design_points.py times each form; PERF.md has the numbers):
//
// 1. The expand leaves the chain.  On an honest strip (below) the run the
//    windowed search finds is the last run whose start <= pos over the
//    whole table, so every thread walks its own column down the rows (its
//    run index only grows) with no search window and no carry from the
//    rows before but the literal cursor lc.  Rows go in chunks of kChunk:
//    one barrier publishes each row's literal count (a vote per warp), then
//    every thread runs the serial recursion lc' = min(lc + count, steps *
//    128 - 1) over the chunk itself, so lc and its clamps are those of the
//    serial form bit for bit.  The inverse is the short scans it is: vdr a
//    per-column running sum in registers, zzr/pdr a warp scan per row and
//    one more barrier per chunk for the warps' totals.
// 2. The run tables live in shared memory (8 bytes an entry; device memory
//    past RLE_ST_SMEM_MAX entries), and the entropy step reads its words
//    from a shared ring of four 128-word rows, loaded with cp.async two
//    steps before any thread can need them.  The ring always holds rows
//    min(cur >> 7, rows - 2) and the next one, the Pallas window, so the
//    clamp is unchanged.  The symbols stay in device memory: in shared
//    memory (64 KB a strip at 256 steps) an SM held a third of the blocks
//    and the launch took 82% longer.
// 3. A step counts its renorm and escape lanes with one vote per flag per
//    warp and one barrier: a warp's exclusive ranks are popc(vote &
//    lanemask_lt), and both counts travel packed in one word per warp.
// 4. One launch per plan: a block reads its (group, strip) descriptor; the
//    group (one bucket) names its operands, sizes, front end, vdd_ws,
//    dense and esc, and its output and scratch offsets in flat buffers.
//    vdd_ws selects a template instance behind a block-uniform switch.
//    The host orders blocks longest chain first (tpu/rans_decode.py:
//    RlePacking).
//
// Honesty test (per strip, block-uniform, after phase 1.5): nrun in [0,
// maxr] and nsame in [0, steps * 128] as given; run starts strictly
// increasing over [0, nrun); and with dense (W = 32) no 32 runs starting
// inside one interval (128 t, 128 t + 128].  Then the run holding pos is
// monotone in pos, every row's runs lie inside the serial search's window
// [rb_t, rb_t + W) (a 256-run window always holds the at most 129 runs a
// row and the next position span when starts strictly increase), and the
// parallel expand equals the serial one bit for bit.  A strip that fails
// takes the serial expand, unchanged: the two searches per row, the
// __syncthreads_count and the block-scan inverse.  The launch's form
// argument forces either expand (1 serial, 2 parallel) for the tests.
//
// Guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (honest streams never reach them): a
// logical shift by >= 32 gives 0, a slot or rank beyond its table reads 0,
// an alias bucket index clamps to 127, the renorm window's first row
// clamps to rows - 2 and the escape cursor to erows * 128 - 256; a symbol
// keeps its low 16 bits (side-stream values are u16); nrun clamps to [0,
// maxr] and nsame to [0, steps * 128]; the run-length and literal-length
// carries saturate at 2^29 (so no int32 sum overflows); the same-value and
// literal reads go through the Pallas kernel's 256-entry windows (first row
// clamped to [0, steps - 2], offset to [0, 255]); the literal cursor clamps
// to steps * 128 - 1; the serial search never reads past st1[maxr - 1].
//
// The MIC_RLE_* macros select other forms for scripts/rle_design_points.py;
// the defaults are the design above.  Two stay because their numbers are
// still read: MIC_RLE_RING=0 (words from device memory) is point 2's
// baseline, whose gain shows alone but not in the plan's launch, for when
// the ring is carried to rans_common.cuh; MIC_RLE_STOP splits the time
// between the phases.  The forms that lost (the shuffle ladder of point 3,
// the symbols in shared memory) are gone; PERF.md keeps their times.
//
// Build: see rans_direct.cu.  The C entry point returns cudaGetLastError()
// after its launch (or the error of the shared-memory opt-in).

#include "rans_common.cuh"

#ifndef MIC_RLE_RING  // 0: words read from device memory after the count
#define MIC_RLE_RING 1
#endif
#ifndef MIC_RLE_STOP  // 1 / 2: stop after phase 1 / 1.5 (a split of the time; no output)
#define MIC_RLE_STOP 0
#endif

namespace {

constexpr int kMid = 16383;     // MID_DIRECT: counts <= kMid are same-runs
constexpr int kHuge = 1 << 30;  // st1 past nrun: start 2^29, never <= pos
constexpr int kCap = 1 << 29;   // saturation of the length carries
constexpr int kRingWords = 4 * kLanes;
constexpr int kChunk = 8;       // expand rows per barrier (out_rows is a multiple of 8)

// One r-mode bucket's operands and sizes (tpu/rans_decode.py:_RLE_GROUP_DESC,
// 168 bytes).  Packed front end: t0 = tpk, t1 = alpha; alias: t0..t2 = w0..w2.
struct RleGroup {
  const uint32_t* init;
  const uint32_t* t0;
  const uint32_t* t1;
  const uint32_t* t2;
  const uint32_t* words;
  const uint32_t* mask;
  const uint32_t* shift;
  const uint32_t* escv;
  const uint32_t* esides;
  const int32_t* ws;
  const int32_t* nrun;
  const int32_t* nsame;
  long long out_off, syms_off, st_off;  // elements; st_off < 0: run tables in shared memory
  int32_t alias, ts, asz, rows, erows, steps, out_rows, maxr, vdd_ws, dense, esc, unused;
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The word stream of one strip, read through the Pallas window: word
// row * 128 + (cur & 127) + k with row = min(cur >> 7, rows - 2).
struct Words {
  const uint32_t* g;  // [rows][128]
  int rows;
  uint32_t* ring;     // rows r at slot r & 3
  int next;           // the next row to load into the ring

  // Rows 0..2 into the ring (made visible by the first step's barrier).
  __device__ __forceinline__ void start(int lane) {
#if MIC_RLE_RING
    for (int r = 0; r < 3 && r < rows; ++r) ring[(r << 7) + lane] = g[(r << 7) + lane];
    next = min(3, rows);
#endif
  }

  __device__ __forceinline__ uint32_t read(int cur, uint32_t k) const {
    const int i = (min(cur >> 7, rows - 2) << 7) + (cur & 127) + (int)k;
#if MIC_RLE_RING
    return ring[(((i >> 7) & 3) << 7) | (i & 127)];
#else
    return g[i];
#endif
  }

  // After a step's reads: load the row two past the new window's first.
  // The window moves by at most one row a step, so the load is complete
  // (the count's wait_group 1 two steps on) before a thread can read it,
  // and it overwrites the row below the current window, which nobody reads
  // again once every thread has passed this step's barrier.
  __device__ __forceinline__ void ahead(int cur, int lane) {
#if MIC_RLE_RING
    const int want = min(min(cur >> 7, rows - 2) + 2, rows - 1);
    if (want >= next) {
      cp_async4(ring + ((next & 3) << 7) + lane, g + ((size_t)next << 7) + lane);
      ++next;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }
};

// Exclusive ranks of two 1-bit flags over the block's 128 lanes and their
// totals, packed a | b << 16 (each count <= 128), with one barrier.  buf
// holds 2 x 4 words (16-byte aligned); phase alternates between them.
struct Counts {
  uint32_t* buf;
  int phase;
  uint32_t tot;

  __device__ __forceinline__ uint32_t ranks(bool a, bool b) {
    const int l32 = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned lt;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
    const unsigned va = __ballot_sync(kFull, a), vb = __ballot_sync(kFull, b);
    const uint32_t ex = (uint32_t)__popc(va & lt) | ((uint32_t)__popc(vb & lt) << 16);
    if (l32 == 0) buf[phase * 4 + warp] = (uint32_t)__popc(va) | ((uint32_t)__popc(vb) << 16);
#if MIC_RLE_RING
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
    __syncthreads();
    const uint4 c = reinterpret_cast<const uint4*>(buf)[phase];
    const uint32_t off = (warp > 0 ? c.x : 0u) + (warp > 1 ? c.y : 0u) + (warp > 2 ? c.z : 0u);
    tot = c.x + c.y + c.z + c.w;
    phase ^= 1;
    return ex + off;
  }
};

struct State {
  uint32_t x, m, sft;
  int cur;
};

// One FF 57 step (tpk[slot] = bias<<12 | rank, alpha[rank] = (freq-1)<<16 |
// sym, both in shared memory); returns the symbol.
struct PackedStep {
  const uint32_t* tpk;
  int ts;
  const uint32_t* alpha;
  int asz;

  __device__ __forceinline__ uint32_t operator()(State& l, Words& w, Counts& c) {
    const uint32_t slot = l.x & l.m;
    const uint32_t pk = slot < (uint32_t)ts ? tpk[slot] : 0u;
    const uint32_t rank = pk & 0xFFFu;
    const uint32_t av = rank < (uint32_t)asz ? alpha[rank] : 0u;
    uint32_t xn = ((av >> 16) + 1u) * shr(l.x, l.sft) + (pk >> 12);
    const bool need = xn < (1u << 16);
    const uint32_t k = c.ranks(need, false);
    if (need) xn = (xn << 16) | w.read(l.cur, k);
    l.cur += (int)(c.tot & 0xFFFFu);
    w.ahead(l.cur, threadIdx.x);
    l.x = xn;
    return av & 0xFFFFu;
  }
};

// One FF 41 step: three lookups in the 128-entry bucket tables (shared
// memory), then with esc the escape substitution from the side stream.
struct AliasStep {
  const uint32_t *w0, *w1, *w2;
  uint32_t ecmp;
  const uint32_t* esides;
  int emax, ecur;
  bool esc;

  __device__ __forceinline__ uint32_t operator()(State& l, Words& w, Counts& c) {
    const uint32_t slot = l.x & l.m;
    const uint32_t bi = min(shr(slot, l.sft - 7u), 127u);
    const uint32_t off = slot & (l.m >> 7);
    const uint32_t g0 = w0[bi], g1 = w1[bi], g2 = w2[bi];
    const uint32_t t = g1 >> 24;
    const bool is_p = off < t;
    const uint32_t fm1 = (is_p ? (g1 >> 12) : (g2 >> 12)) & 0xFFFu;
    const uint32_t sb = (is_p ? g1 : g2) & 0xFFFu;
    const uint32_t j = sb + off - (is_p ? 0u : t);
    uint32_t sym = is_p ? (g0 >> 16) : (g0 & 0xFFFFu);
    uint32_t xn = (fm1 + 1u) * shr(l.x, l.sft) + j;
    const bool need = xn < (1u << 16);
    const bool is_esc = esc && sym == ecmp;
    const uint32_t k = c.ranks(need, is_esc);
    if (is_esc) sym = esides[min(ecur, emax) + (int)(k >> 16)];
    ecur += (int)(c.tot >> 16);
    if (need) xn = (xn << 16) | w.read(l.cur, k & 0xFFFFu);
    l.cur += (int)(c.tot & 0xFFFFu);
    w.ahead(l.cur, threadIdx.x);
    l.x = xn;
    return sym;
  }
};

template <class Step>
__device__ __forceinline__ void entropy(Step& step, State& l, Words& w, Counts& c,
                                        uint16_t* syms, int steps) {
  const int lane = threadIdx.x;
  for (int t = 0; t < steps; ++t) syms[t * kLanes + lane] = (uint16_t)step(l, w, c);
#if MIC_RLE_RING
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Last run r in [rb, min(rb + w, maxr) - 1] whose start <= pos (rb if none).
__device__ __forceinline__ int find_run(const int* st1, int rb, int pos, int maxr, int w) {
  int r = rb;
  for (int step = w >> 1; step > 0; step >>= 1) {
    const int c = r + step;
    if (c < maxr && (st1[c] >> 1) <= pos) r = c;
  }
  return r;
}

// Phase 2, serial form: one row a step, each thread searching the window
// of W runs from rb, the run holding the row's first pixel.
template <int VWS>
__device__ __forceinline__ void expand_serial(const int* st1, const int* st2,
                                              const uint16_t* syms, int nrun, int nsame,
                                              int ws, uint16_t* out, int steps, int out_rows,
                                              int maxr, int w, uint32_t* buf, int& phase) {
  const int lane = threadIdx.x;
  constexpr int U = VWS > 0 ? VWS : 1;
  const int lmax = steps * kLanes - 1;
  Inverse<VWS> inverse(ws);
  int rb = 0, lc = nrun + nsame;
  for (int t0 = 0; t0 < out_rows; t0 += U) {
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const int row0 = (t0 + c) * kLanes, pos = row0 + lane;
      const int r = find_run(st1, rb, pos, maxr, w);
      const int rn = find_run(st1, rb, row0 + kLanes, maxr, w);
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

// Phase 2, parallel form (honest strips): each thread walks its column's
// runs down the rows; kChunk rows per barrier.  cb holds 2 x kChunk x 4
// literal counts, tb kChunk x 4 warp totals (both 16-byte aligned).
template <int VWS>
__device__ __forceinline__ void expand_parallel(const int* st1, const int* st2,
                                                const uint16_t* syms, int nrun, int nsame,
                                                int ws, uint16_t* out, int steps, int out_rows,
                                                uint32_t* cb, uint32_t* tb) {
  const int lane = threadIdx.x, l32 = lane & 31, warp = lane >> 5;
  const int lmax = steps * kLanes - 1;
  int r = 0, lc = nrun + nsame, rcnt = 0;
  uint32_t prev[VWS > 0 ? VWS : 1], rowc = 0;
#pragma unroll
  for (int i = 0; i < (VWS > 0 ? VWS : 1); ++i) prev[i] = 0;
  for (int t0 = 0, half = 0; t0 < out_rows; t0 += kChunk, half ^= 1) {
    uint32_t* cbh = cb + half * kChunk * 4;
    int g2[kChunk];
    bool lit[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int pos = (t0 + k) * kLanes + lane;
      while (r + 1 < nrun && (st1[r + 1] >> 1) <= pos) ++r;
      lit[k] = !(st1[r] & 1);
      g2[k] = st2[r];
      const unsigned v = __ballot_sync(kFull, lit[k]);
      if (l32 == 0) cbh[k * 4 + warp] = (uint32_t)__popc(v);
    }
    __syncthreads();
    uint32_t dz[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const uint4 n = reinterpret_cast<const uint4*>(cbh)[k];
      const int pos = (t0 + k) * kLanes + lane;
      const int lrow = min(lc >> 7, steps - 2);
      const int li = min(max(g2[k] + pos - (lrow << 7), 0), 255);
      const int tok = lit[k] ? (int)syms[(lrow << 7) + li] : g2[k];
      lc = min(lc + (int)(n.x + n.y + n.z + n.w), lmax);
      dz[k] = (uint32_t)unzigzag((uint32_t)tok);
    }
    if (VWS > 0) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int c = k % (VWS > 0 ? VWS : 1);
        prev[c] = (prev[c] + dz[k]) & 0xFFFFu;
        out[(size_t)(t0 + k) * kLanes + lane] = (uint16_t)prev[c];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(kFull, dz[k], o);
          if (l32 >= o) dz[k] += t;
        }
        if (l32 == 31) tb[k * 4 + warp] = dz[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const uint4 c = reinterpret_cast<const uint4*>(tb)[k];
        const uint32_t off = (warp > 0 ? c.x : 0u) + (warp > 1 ? c.y : 0u) + (warp > 2 ? c.z : 0u);
        if (rcnt == 0) rowc = 0;
        out[(size_t)(t0 + k) * kLanes + lane] = (uint16_t)((rowc + dz[k] + off) & 0xFFFFu);
        rowc = (rowc + c.x + c.y + c.z + c.w) & 0xFFFFu;
        if (++rcnt >= ws) rcnt = 0;
      }
    }
  }
}

// Phases 1.5 and 2 of one strip, after its symbols are in syms.
__device__ __forceinline__ void expand_strip(const RleGroup& g, int s, const uint16_t* syms,
                                             int* st1, int* st2, uint16_t* out, int form,
                                             uint32_t* buf, uint32_t* cb, uint32_t* tb) {
  const int lane = threadIdx.x, steps = g.steps, maxr = g.maxr;
  const size_t s0 = (size_t)s * kLanes;
  const int nrun_in = g.nrun[s0], nsame_in = g.nsame[s0];
  int phase = 0;
  // 1.5 run tables
  const int nrun = min(max(nrun_in, 0), maxr);
  const int nsame = min(max(nsame_in, 0), steps * kLanes);
  int len_c = 0, same_c = 0, lit_c = 0;
  for (int rr = 0; rr < maxr / kLanes; ++rr) {
    const int ridx = rr * kLanes + lane;
    const int c = syms[ridx];
    const bool valid = ridx < nrun;
    const bool is_s = valid && c <= kMid;
    const uint32_t len = valid ? (uint32_t)(is_s ? c : c - kMid) : 0u;
    const uint32_t litl = is_s ? 0u : len;
    uint32_t a = len, b = litl, ta, tb2, si = is_s, zero = 0, tsi, tz;
    block_scan2(a, b, ta, tb2, buf, phase);
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
    lit_c = min(lit_c + (int)tb2, kCap);
  }
  __syncthreads();
  if (MIC_RLE_STOP == 2) return;

  // the honesty test (see the note at the top)
  bool par = form == 2;
  if (form == 0) {
    bool ok = nrun_in == nrun && nsame_in == nsame;
    for (int c = lane + (lane == 0 ? kLanes : 0); c < nrun; c += kLanes) {
      const int sc = st1[c] >> 1;
      if (sc <= (st1[c - 1] >> 1)) ok = false;
      if (g.dense && c >= 31 && ((sc - 1) >> 7) == (((st1[c - 31] >> 1) - 1) >> 7)) ok = false;
    }
    par = __syncthreads_and(ok);
  }

  const int ws = g.ws[s0], w = g.dense ? 32 : 256;
#define MIC_RLE_EXPAND(V)                                                                  \
  if (par)                                                                                 \
    expand_parallel<V>(st1, st2, syms, nrun, nsame, ws, out, steps, g.out_rows, cb, tb);   \
  else                                                                                     \
    expand_serial<V>(st1, st2, syms, nrun, nsame, ws, out, steps, g.out_rows, maxr, w, buf, \
                     phase)
  switch (g.vdd_ws) {
    case 0: MIC_RLE_EXPAND(0); break;
    case 1: MIC_RLE_EXPAND(1); break;
    case 2: MIC_RLE_EXPAND(2); break;
    case 4: MIC_RLE_EXPAND(4); break;
    default: MIC_RLE_EXPAND(8); break;  // the host takes only 0, 1, 2, 4, 8
  }
#undef MIC_RLE_EXPAND
}

// Dynamic shared memory: tables (tab_words), run tables (st_words), the
// word ring.
__global__ void __launch_bounds__(kLanes)
rle_groups_kernel(const RleGroup* __restrict__ groups, const int2* __restrict__ blocks,
                  uint16_t* __restrict__ out, uint16_t* syms_g, int* st_g, int tab_words,
                  int st_words, int form) {
  extern __shared__ uint4 smem4[];
  __shared__ uint32_t scan_buf[16];
  __shared__ __align__(16) uint32_t cnt_buf[8];
  __shared__ __align__(16) uint32_t cb[2 * kChunk * 4];
  __shared__ __align__(16) uint32_t tb[kChunk * 4];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int2 bd = blocks[blockIdx.x];
  const RleGroup& g = groups[bd.x];
  const int s = bd.y, lane = threadIdx.x;
  const size_t li = (size_t)s * kLanes + lane;
  uint32_t* tab = smem;
  uint32_t* ring = smem + tab_words + st_words;
  int* st1 = g.st_off < 0 ? reinterpret_cast<int*>(smem + tab_words)
                          : st_g + g.st_off + (size_t)s * 2 * g.maxr;
  int* st2 = st1 + g.maxr;
  uint16_t* syms = syms_g + g.syms_off + (size_t)s * g.steps * kLanes;

  Words w{g.words + (size_t)s * g.rows * kLanes, g.rows, ring, 0};
  State l{g.init[li], g.mask[li], g.shift[li], 0};
  Counts c{cnt_buf, 0, 0};
  w.start(lane);
  if (g.alias) {
    tab[lane] = g.t0[li];
    tab[kLanes + lane] = g.t1[li];
    tab[2 * kLanes + lane] = g.t2[li];
    __syncthreads();
    AliasStep step{tab, tab + kLanes, tab + 2 * kLanes, g.escv[li],
                   g.esides + (size_t)s * g.erows * kLanes, g.erows * kLanes - 256, 0,
                   g.esc != 0};
    entropy(step, l, w, c, syms, g.steps);
  } else {
    const int ts = g.ts, asz = g.asz;
    for (int i = lane; i < ts; i += kLanes) tab[i] = g.t0[(size_t)s * ts + i];
    for (int i = lane; i < asz; i += kLanes) tab[ts + i] = g.t1[(size_t)s * asz + i];
    __syncthreads();
    PackedStep step{tab, ts, tab + ts, asz};
    entropy(step, l, w, c, syms, g.steps);
  }
  __syncthreads();
  if (MIC_RLE_STOP == 1) return;
  expand_strip(g, s, syms, st1, st2, out + g.out_off + (size_t)s * g.out_rows * kLanes, form,
               scan_buf, cb, tb);
}

}  // namespace

extern "C" {

// groups: RleGroup[n_groups] and blocks: int2[n_blocks] (group, strip), both
// on the device; out / syms / st: the flat buffers the groups' offsets
// index.  form: 0 the honesty test picks the expand, 1 serial, 2 parallel.
int mic_rle_decode_groups(const void* groups, const void* blocks, int n_blocks, void* out,
                          void* syms, void* st, int tab_words, int st_words, int form,
                          void* stream) {
  if (n_blocks <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = sizeof(uint32_t) * (16 + 8 + 3 * kChunk * 4);
  const size_t smem = sizeof(uint32_t) * ((size_t)tab_words + st_words + kRingWords);
  if (smem + fixed > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(rle_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  rle_groups_kernel<<<n_blocks, kLanes, smem, (cudaStream_t)stream>>>(
      (const RleGroup*)groups, (const int2*)blocks, (uint16_t*)out, (uint16_t*)syms, (int*)st,
      tab_words, st_words, form);
  return (int)cudaGetLastError();
}

}  // extern "C"
