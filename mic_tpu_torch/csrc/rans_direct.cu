// Fused direct-mode decode of MICW (zzd / vdd / pdd) for Hopper: rANS, the
// predictor inverse and pdd's column sum in one kernel; and the symbols-out
// decode of the post path's strips.  Every direct and post bucket of a
// decode plan runs in one launch (two where a plan holds strips whose
// tables fit no block of the first).
//
// direct_groups_kernel replaces four Pallas kernels, the front end chosen
// per strip:
//
// * mic_tpu/tpu/pallas_rans.py:_kernel_zzd (wrapper rans_decode_pallas_zzd)
//   and _kernel_packed (wrapper rans_decode_pallas_packed, the symbols):
//   the FF 57 packed-table front end, tpk[slot] = bias<<12 | rank and
//   alpha[rank] = (freq-1)<<16 | sym;
// * pallas_rans.py:_kernel_alias (wrapper rans_decode_pallas_alias, its
//   fused form and its fused=False form): the FF 41 front end, three
//   lookups in the 128-entry bucket tables plus the escape substitution
//   from the side stream;
// * pallas_rans.py:_kernel (wrapper rans_decode_pallas, the symbols): the
//   FF 57 two-table front end for tableLog up to 16 or alphabets over
//   4096, tsym[slot] = sym and tfb[slot] = freq<<16 | bias, two
//   independent reads of one level (not re-ranked into the packed layout,
//   which would put a second dependent read on the chain);
//
// each followed by one inverse: none (the symbols), zzd (unzigzag, then the
// row prefix with its reset every ws steps), vdd (unzigzag, then the
// previous-row carry of vdd_ws 128-lane chunks) or pdd (zzd's row prefix,
// then the column sum of cw chunks that mic_tpu runs as a cumsum after its
// kernel: strips.py:_stacked_zzd_fused).
//
// What bounds it on this card: a strip is a serial chain of dependent
// steps (a 512-step strip moves ~128 KB of pixels and ~60 KB of words; the
// batch's bytes take tens of microseconds).  The previous kernels put a
// block barrier, two shuffle ladders and a word read from device memory on
// every step of that chain.  Here a step of a strip alone on its SM takes
// ~230 ns: ~200 warp instructions for 128 lanes, issued by one warp, around
// three dependent shared-memory reads (two table levels, the ring).  A
// plan's launch lasts its longest chains (the 1024-step strips), slowed by
// the other warps of their SMs.  The design, point by point
// (scripts/direct_design_points.py times each form; PERF.md has the
// numbers):
//
// 1. A warp per strip (a team of MIC_DIRECT_TEAM = 32 threads; 128 is the
//    block-of-128 design point, one named barrier a team).  Each thread
//    holds 4 of the strip's 128 interleaved rANS states: 4 independent
//    chains.  Layout MIC_DIRECT_LAYOUT 0 is contiguous (thread j holds
//    lanes 4j..4j+3: one 8-byte store a row, the row scan 3 local adds
//    and one 5-round ladder), 1 strided (thread j holds j, j+32, j+64,
//    j+96: each ring read instruction stays in a 32-word window).
// 2. The renorm ranks come from 4 __ballot_sync and __popc under
//    lanemask_lt, the step's total from the popcounts: nothing waits on
//    another warp.
// 3. Words come from a ring in shared memory: row r of the strip's stream
//    at slot r & 7 (8 x 128 words), filled by cp.async (16 bytes a thread
//    a row) kLead = 6 rows ahead of the window's first, so a copy has 6
//    steps to land.  The ring holds rows min(cur >> 7, rows - 2) and the
//    next one, the Pallas window, so the clamp is unchanged (as Words in
//    rans_rle.cu; this file keeps its own copy).  Every lane reads its word
//    and the state takes it where it needs one: no branch.
// 4. The escapes and the inverse leave the chain: the chain runs U = 4
//    steps and keeps their symbols; then the escapes of the U rows are
//    counted the same way and read from a second ring (16 rows, loaded 10
//    ahead), and the inverse takes the U rows at once (unzigzag; the zzd /
//    pdd row prefix as U warp scans side by side, with its reset every ws
//    steps; vdd's and pdd's column carry of cw chunks, u16 in shared
//    memory).  The inverse is chosen at run time, so the kernel has one
//    code path per front end.
// 5. Tables in shared memory, sized per strip: tpk + alpha of its group
//    (up to 32 KB at tl 12 with a 4096 alphabet; each ends in a zero word,
//    so the guard is a min), the alias bucket tables 1.5 KB, the two
//    tables 6 bytes a slot (tfb as u32, tsym narrowed to u16 by the host:
//    48 KB at tl 13, 192 KB at tl 15; a slot past them reads 0 by a
//    predicated read).  At tl 16 (384 KB) they do not fit a block and the
//    step reads them from device memory (tdev).  A block runs up to 4
//    strips (teams), each at the word offset its descriptor gives; the host
//    (tpu/rans_decode.py:DirectPacking) fills blocks with consecutive
//    strips, longest chain first: 4 a block, or fewer where the launch's
//    largest strip leaves no room for them (one at tl 15).
// 6. One launch per plan: a team reads its (group, strip, offset)
//    descriptor; the group (one bucket) names its operands, sizes, front
//    end, inverse, chunk count, esc and output offset in one flat buffer.
//    The shared memory is addressed by word offsets from the kernel's one
//    extern array (a pointer into it kept in a struct made the compiler
//    rebuild the shared window's address at every access).
//
// Guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_decode.py (valid operands never reach them):
// a logical shift by >= 32 gives 0 (PTX shr.u32 clamps its shift to 32);
// a slot or rank past its table reads 0; the alias bucket index clamps to
// 127; the word window's first row clamps to rows - 2; the escape cursor
// clamps to erows * 128 - 256.
//
// The MIC_DIRECT_* macros select the design points for
// scripts/direct_design_points.py; the defaults are the design above.
// MIC_DIRECT_RING=0 reads the words from device memory after the count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch (or the error of the shared-memory
// opt-in).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MIC_DIRECT_TEAM  // threads per strip: 32 (a warp) or 128
#define MIC_DIRECT_TEAM 32
#endif
#ifndef MIC_DIRECT_LAYOUT  // 0: contiguous lanes per thread, 1: strided
#define MIC_DIRECT_LAYOUT 0
#endif
#ifndef MIC_DIRECT_RING  // 0: words read from device memory
#define MIC_DIRECT_RING 1
#endif

namespace {

constexpr int kLanes = 128;
constexpr int kTeam = MIC_DIRECT_TEAM;
constexpr int kLpt = kLanes / kTeam;  // lanes (rANS states) a thread holds
constexpr int kStrips = 4;            // strips (teams) a block
constexpr int kThreads = kTeam * kStrips;
constexpr int kRingRows = 8;          // the ring: row r of the stream at slot r & 7
constexpr int kLead = 6;              // rows loaded ahead of the window's first
constexpr int kRingWords = kRingRows * kLanes;
constexpr int kMaxU = 4;              // steps a batch
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPacked = 0, kAlias = 1, kTwoTable = 2;  // DirectGroup::front
static_assert(kTeam == 32 || kTeam == 128, "a team is a warp or four");

// The block's dynamic shared memory, addressed by word offsets.
extern __shared__ __align__(16) uint32_t smem_w[];

// One bucket's operands and sizes (tpu/rans_decode.py:_DIRECT_GROUP_DESC,
// 128 bytes).  front: kPacked (t0 = tpk, t1 = alpha), kAlias (t0..t2 =
// w0..w2) or kTwoTable (t0 = tfb [S][ts], t1 = the u16 symbols [S][asz],
// asz = ts rounded up to 8; tdev: read from device memory, not staged).
// inv: 0 symbols, 1 zzd, 2 vdd (cw = vdd_ws), 3 pdd (cw = chunks a row).
struct DirectGroup {
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
  long long out_off;  // elements of the flat output
  int32_t front, ts, asz, rows, erows, steps, inv, cw, esc, tdev;
};

__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shr.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));  // s >= 32 gives 0
  return r;
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t sym) {
  const int si = (int)sym;
  return (uint32_t)((si >> 1) ^ (-(si & 1)));
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  return lt;
}

// The strip lane of a thread's k-th state.
__device__ __forceinline__ int lane_of(int tid, int k) {
  return MIC_DIRECT_LAYOUT == 0 ? tid * kLpt + k : tid + kTeam * k;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// The threads of one strip, and what they exchange: a team of 128 shares
// warp totals through buf (double-buffered, 2 x kMaxU x 4 words; one named
// barrier a call, so a half is written again only after every read of it).
struct Team {
  int tid, id;
  uint32_t* buf;
  int phase;

  __device__ __forceinline__ void sync() const {
#if MIC_DIRECT_TEAM == 32
    __syncwarp();
#else
    asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "r"(kTeam) : "memory");
#endif
  }

  // For N values at once: adds the totals of the team's earlier warps to
  // each warp-local value v[i] (whose warp total is wt[i]) and returns the
  // team totals in wt.  A warp-sized team has nothing to add.
  template <int N>
  __device__ __forceinline__ void across(uint32_t (&v)[N], uint32_t (&wt)[N]) {
#if MIC_DIRECT_TEAM == 128
    const int warp = tid >> 5;
    uint32_t* b = buf + phase * kMaxU * 4;
    if ((tid & 31) == 31)
#pragma unroll
      for (int i = 0; i < N; ++i) b[i * 4 + warp] = wt[i];
    sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint4 c = reinterpret_cast<const uint4*>(b)[i];
      v[i] += (warp > 0 ? c.x : 0u) + (warp > 1 ? c.y : 0u) + (warp > 2 ? c.z : 0u);
      wt[i] = c.x + c.y + c.z + c.w;
    }
    phase ^= 1;
#endif
  }
};

// Exclusive ranks, in lane order over the warp's lanes, of the lanes whose
// flag is set; returns the warp's count.
__device__ __forceinline__ uint32_t warp_ranks(const bool (&f)[kLpt], uint32_t (&r)[kLpt]) {
  const unsigned lt = lanemask_lt();
  uint32_t run = 0;
#if MIC_DIRECT_LAYOUT == 0
  uint32_t below = 0;
#pragma unroll
  for (int k = 0; k < kLpt; ++k) {
    const unsigned v = __ballot_sync(kFull, f[k]);
    below += __popc(v & lt);
    run += __popc(v);
  }
#pragma unroll
  for (int k = 0; k < kLpt; ++k) {
    r[k] = below;
    below += f[k];
  }
#else
#pragma unroll
  for (int k = 0; k < kLpt; ++k) {
    const unsigned v = __ballot_sync(kFull, f[k]);
    r[k] = run + __popc(v & lt);
    run += __popc(v);
  }
#endif
  return run;
}

// Inclusive prefix sums of U rows of the strip's lanes in lane order, in
// place (mod 2^32); tot receives each row's total.  The rows' ladders run
// side by side.
template <int U>
__device__ __forceinline__ void team_scan(uint32_t (&v)[U][kLpt], uint32_t (&tot)[U], Team& tm) {
  const int l32 = tm.tid & 31;
#if MIC_DIRECT_LAYOUT == 0 || MIC_DIRECT_TEAM == 128
  uint32_t s[U], excl[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 1; k < kLpt; ++k) v[u][k] += v[u][k - 1];
    s[u] = v[u][kLpt - 1];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t t = __shfl_up_sync(kFull, s[u], o);
      if (l32 >= o) s[u] += t;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    excl[u] = s[u] - v[u][kLpt - 1];
    tot[u] = __shfl_sync(kFull, s[u], 31);
  }
  tm.across(excl, tot);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < kLpt; ++k) v[u][k] += excl[u];
#else
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < kLpt; ++k) {
        const uint32_t t = __shfl_up_sync(kFull, v[u][k], o);
        if (l32 >= o) v[u][k] += t;
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < kLpt; ++k) {
      const uint32_t t = __shfl_sync(kFull, v[u][k], 31);
      v[u][k] += run;
      run += t;
    }
    tot[u] = run;
  }
#endif
}

// kLpt u16 values of the thread's lanes in a row of 128 (a shared or a
// device-memory row).
__device__ __forceinline__ void ld_row(const uint16_t* row, int tid, uint32_t (&v)[kLpt]) {
#if MIC_DIRECT_LAYOUT == 0 && MIC_DIRECT_TEAM == 32
  const uint2 q = *reinterpret_cast<const uint2*>(row + 4 * tid);
  v[0] = q.x & 0xFFFFu;
  v[1] = q.x >> 16;
  v[2] = q.y & 0xFFFFu;
  v[3] = q.y >> 16;
#else
#pragma unroll
  for (int k = 0; k < kLpt; ++k) v[k] = row[lane_of(tid, k)];
#endif
}

__device__ __forceinline__ void st_row(uint16_t* row, int tid, const uint32_t (&v)[kLpt]) {
#if MIC_DIRECT_LAYOUT == 0 && MIC_DIRECT_TEAM == 32
  *reinterpret_cast<uint2*>(row + 4 * tid) =
      make_uint2(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
#else
#pragma unroll
  for (int k = 0; k < kLpt; ++k) row[lane_of(tid, k)] = (uint16_t)v[k];
#endif
}

// n words from device memory to shared word offset dst, asynchronously (16
// bytes a copy where both sides allow it).
__device__ __forceinline__ void copy_words(int dst, const uint32_t* src, int n, int tid) {
  if (((reinterpret_cast<uintptr_t>(src) & 15) == 0) && (n & 3) == 0) {
    for (int i = 4 * tid; i < n; i += 4 * kTeam) cp_async16(smem_w + dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += kTeam) cp_async4(smem_w + dst + i, src + i);
  }
}

// A stream of one strip in a ring of ROWS rows in shared memory, read
// through the Pallas window: word row * 128 + off + k with row =
// min(cur >> 7, rows - 2) (the word stream: off = cur & 127; the escape
// side stream: row * 128 + off = min(cur, rows * 128 - 256)).
template <int ROWS, int LEAD>
struct Ring {
  static_assert(LEAD + 2 <= ROWS, "a load must not overwrite a row still read");
  const uint32_t* g;  // [rows][128]
  int rows;
  int ring;           // shared word offset of the ring: row r at slot r % ROWS
  int next;           // the next row to load into the ring

  __device__ __forceinline__ void load_row(int r, int tid) {
    uint32_t* dst = smem_w + ring + ((r & (ROWS - 1)) << 7);
    if (kLpt == 4)
      cp_async16(dst + 4 * tid, g + ((size_t)r << 7) + 4 * tid);
    else
      cp_async4(dst + tid, g + ((size_t)r << 7) + tid);
  }

  // Rows 0..LEAD into the ring (waited for with the tables).
  __device__ __forceinline__ void start(int tid) {
    next = min(LEAD + 1, rows);
#if MIC_DIRECT_RING
    for (int r = 0; r < next; ++r) load_row(r, tid);
#endif
  }

  __device__ __forceinline__ uint32_t read(int i) const {
#if MIC_DIRECT_RING
    return smem_w[ring + (i & (ROWS * kLanes - 1))];
#else
    return __ldg(g + i);
#endif
  }

  // After a step's reads: load the row LEAD past the new window's first
  // (the chain step commits its copies as one group).  The window moves
  // by at most one row a step, and the row overwritten is ROWS - LEAD >= 2
  // below the window, which nobody reads again.
  __device__ __forceinline__ void ahead(int cur, int tid) {
#if MIC_DIRECT_RING
    const int want = min(min(cur >> 7, rows - 2) + LEAD, rows - 1);
    if (want >= next) {
      load_row(next, tid);
      ++next;
    }
#endif
  }
};

// The words: a copy committed by chain step t is waited for at step t +
// kLead - 1, before the first read that can need it.
using Words = Ring<kRingRows, kLead>;
__device__ __forceinline__ void wait_words() {
#if MIC_DIRECT_RING
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
#endif
}
// The escapes: read in the inverse of each batch of U rows, which runs
// after the batch's U chain steps.  A row loaded in batch b's inverse is
// committed with batch b + 1's first step and waited for by batch b + 2's
// chain (wait_words), so it can be read from batch b + 2's inverse on;
// loaded kEscLead >= 2 U + 1 rows ahead, it is first needed there at the
// earliest.
constexpr int kEscRows = 16, kEscLead = 10;
static_assert(kEscLead >= 2 * kMaxU + 1, "an escape row must land before its first read");
using Escapes = Ring<kEscRows, kEscLead>;

// The inverse of one strip over batches of U rows, chosen per group at
// run time (one code path per front end keeps the launch's code small: a
// template instance per inverse and chunk count was ~20 KB each, and
// strips of several groups on one SM thrashed the instruction cache):
// inv 0 passes the symbols; otherwise unzigzag, then for zzd / pdd (inv 1,
// 3) the row prefix with its reset every ws steps, then for vdd / pdd (inv
// 2, 3) the column carry of cw chunks, u16 in shared memory at word
// offset carry.
struct Inverse {
  uint32_t rowc;
  int rcnt, ws, ccnt, cw, carry;
  bool zz, row, col;

  __device__ __forceinline__ Inverse(int inv, int ws_, int cw_, int carry_)
      : rowc(0), rcnt(0), ws(ws_), ccnt(0), cw(cw_), carry(carry_), zz(inv != 0),
        row(inv == 1 || inv == 3), col(inv >= 2) {}

  // v: U rows of symbols in, pixels out.
  template <int U>
  __device__ __forceinline__ void operator()(uint32_t (&v)[U][kLpt], Team& tm) {
    if (!zz) return;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < kLpt; ++k) v[u][k] = unzigzag(v[u][k]);
    if (row) {
      uint32_t tot[U];
      team_scan(v, tot, tm);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (rcnt == 0) rowc = 0;
#pragma unroll
        for (int k = 0; k < kLpt; ++k) v[u][k] += rowc;
        rowc += tot[u];
        if (++rcnt >= ws) rcnt = 0;
      }
    }
    if (col) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        uint16_t* r = reinterpret_cast<uint16_t*>(smem_w + carry) + ccnt * kLanes;
        uint32_t prev[kLpt];
        ld_row(r, tm.tid, prev);
#pragma unroll
        for (int k = 0; k < kLpt; ++k) v[u][k] += prev[k];
        st_row(r, tm.tid, v[u]);
        if (++ccnt >= cw) ccnt = 0;
      }
    }
  }
};

// Shared-memory words of a strip's tables (the host's layout, which puts
// the word ring before them and, for an alias strip with escapes, the
// escapes' ring and then the column carry after them): a packed table and
// its alphabet each end in a zero word (what a slot or rank past them
// reads), the alias bucket tables are (w1, w2) pairs then w0, the two
// tables are tfb (ts words, rounded up to 4) then the u16 symbols (asz / 2
// words), or nothing when the step reads them from device memory.
__device__ __forceinline__ int ts_words(int ts) { return (ts + 4) & ~3; }
__device__ __forceinline__ int tab_words(const DirectGroup& g) {
  if (g.front == kAlias) return 3 * kLanes;
  if (g.front == kPacked) return ts_words(g.ts) + ts_words(g.asz);
  return g.tdev ? 0 : ((g.ts + 3) & ~3) + g.asz / 2;
}

// TDEV (kTwoTable only): the two tables are read from device memory.  It
// is a template argument, not a run-time choice inside the step: with the
// choice there (both reads in the unrolled step, one predicated off), a
// staged tl 13 step took 338 ns alone; as a template argument, 190 (the
// packed step: 167).  Only tl 16 strips run the TDEV instance.
template <int FRONT, bool TDEV = false>
__device__ __forceinline__ void decode_strip(const DirectGroup& g, int s, int sm,
                                             uint16_t* __restrict__ out, Team& tm) {
  const int tid = tm.tid;
  const size_t s0 = (size_t)s * kLanes;
  const int steps = g.steps, rows = g.rows;
  constexpr bool ALIAS = FRONT == kAlias;
  const uint32_t ts = (uint32_t)g.ts, asz = (uint32_t)g.asz;
  const bool esc = ALIAS && g.esc;
  constexpr bool tdev = FRONT == kTwoTable && TDEV;
  uint32_t x[kLpt], m[kLpt], sft[kLpt], ecmp[kLpt];
#pragma unroll
  for (int k = 0; k < kLpt; ++k) {
    const size_t li = s0 + lane_of(tid, k);
    x[k] = g.init[li];
    m[k] = g.mask[li];
    sft[k] = g.shift[li];
    ecmp[k] = ALIAS ? g.escv[li] : 0u;
  }

  const int tab = sm + kRingWords;  // tpk | w12 | tfb
  const int tab2 = tab + (ALIAS ? 2 * kLanes : FRONT == kPacked ? ts_words(ts)
                                                                 : (int)((ts + 3) & ~3u));
  const int ering = tab + tab_words(g);  // (alpha | w0 | the u16 symbols at tab2)
  const int carry = ering + (esc ? kEscRows * kLanes : 0);
  // The two tables of this strip in device memory (read there when tdev).
  const uint32_t* gfb = g.t0 + (size_t)s * ts;
  const uint16_t* gsym = reinterpret_cast<const uint16_t*>(g.t1) + (size_t)s * asz;
  const uint16_t* ssym = reinterpret_cast<const uint16_t*>(smem_w) + 2 * tab2;
  if (ALIAS) {
    for (int i = tid; i < kLanes; i += kTeam) {
      smem_w[tab + 2 * i] = g.t1[s0 + i];
      smem_w[tab + 2 * i + 1] = g.t2[s0 + i];
      smem_w[tab2 + i] = g.t0[s0 + i];
    }
  } else if (FRONT == kPacked) {
    copy_words(tab, g.t0 + (size_t)s * ts, ts, tid);
    copy_words(tab2, g.t1 + (size_t)s * asz, asz, tid);
    if (tid == 0) {
      smem_w[tab + ts] = 0u;
      smem_w[tab2 + asz] = 0u;
    }
  } else if (!tdev) {
    copy_words(tab, gfb, ts, tid);
    copy_words(tab2, reinterpret_cast<const uint32_t*>(gsym), asz / 2, tid);
  }
  if (g.inv >= 2)
    for (int i = tid; i < g.cw * (kLanes / 2); i += kTeam) smem_w[carry + i] = 0u;
  Words w{g.words + s0 * rows, rows, sm, 0};
  w.start(tid);
  Escapes ew{ALIAS ? g.esides + s0 * g.erows : nullptr, g.erows, ering, 0};
  if (esc) ew.start(tid);
  cp_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  tm.sync();

  const int emax = g.erows * kLanes - 256;
  int cur = 0, ecur = 0;
  Inverse inverse(g.inv, (g.inv & 1) ? g.ws[s0] : 0, g.cw, carry);  // ws: zzd, pdd
  uint16_t* o = out + g.out_off + (size_t)s * steps * kLanes;
  constexpr int U = kMaxU;  // steps is a multiple of 8
  for (int t0 = 0; t0 < steps; t0 += U) {
    uint32_t v[U][kLpt];
    // The chain: U steps of the states, their symbols into v.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t xn[kLpt], rn[kLpt];
      bool need[kLpt];
#pragma unroll
      for (int k = 0; k < kLpt; ++k) {
        const uint32_t slot = x[k] & m[k];
        if (ALIAS) {
          const uint32_t bi = min(shr(slot, sft[k] - 7u), 127u);
          const uint32_t off = slot & (m[k] >> 7);
          const uint2 g12 = reinterpret_cast<const uint2*>(smem_w + tab)[bi];
          const uint32_t g0 = smem_w[tab2 + bi];
          const uint32_t t = g12.x >> 24;
          const bool is_p = off < t;
          const uint32_t gg = is_p ? g12.x : g12.y;
          v[u][k] = is_p ? (g0 >> 16) : (g0 & 0xFFFFu);
          xn[k] = (((gg >> 12) & 0xFFFu) + 1u) * shr(x[k], sft[k]) + (gg & 0xFFFu) + off -
                  (is_p ? 0u : t);
        } else if (FRONT == kPacked) {
          const uint32_t pk = smem_w[tab + min(slot, ts)];
          const uint32_t av = smem_w[tab2 + min(pk & 0xFFFu, asz)];
          v[u][k] = av & 0xFFFFu;
          xn[k] = ((av >> 16) + 1u) * shr(x[k], sft[k]) + (pk >> 12);
        } else {  // two tables: two independent reads, one level
          const bool in = slot < ts;
          uint32_t fb, sy;
          if constexpr (tdev) {
            fb = in ? __ldg(gfb + slot) : 0u;
            sy = in ? (uint32_t)__ldg(gsym + slot) : 0u;
          } else {
            fb = in ? smem_w[tab + slot] : 0u;
            sy = in ? (uint32_t)ssym[slot] : 0u;
          }
          v[u][k] = sy;
          xn[k] = (fb >> 16) * shr(x[k], sft[k]) + (fb & 0xFFFFu);
        }
        need[k] = xn[k] < (1u << 16);
      }
      uint32_t off[1] = {0}, tot[1] = {warp_ranks(need, rn)};
      wait_words();
      tm.across(off, tot);
      if (kTeam == 32) tm.sync();
      const int base = (min(cur >> 7, rows - 2) << 7) + (cur & 127) + (int)off[0];
#pragma unroll
      for (int k = 0; k < kLpt; ++k) {
        const uint32_t word = w.read(base + (int)rn[k]);
        x[k] = need[k] ? (xn[k] << 16) | word : xn[k];
      }
      cur += (int)tot[0];
      w.ahead(cur, tid);
#if MIC_DIRECT_RING
      cp_commit();
#endif
    }
    // The escapes of the U rows, off the chain: lanes whose symbol is the
    // strip's escape value take the side stream's next values, in lane
    // order, row by row.
    if (esc) {
      bool e[U][kLpt];
      uint32_t re[U][kLpt], cnt[U], off[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < kLpt; ++k) e[u][k] = v[u][k] == ecmp[k];
        cnt[u] = warp_ranks(e[u], re[u]);
        off[u] = 0;
      }
      tm.across(off, cnt);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int eb = min(ecur, emax) + (int)off[u];
#pragma unroll
        for (int k = 0; k < kLpt; ++k)
          if (e[u][k]) v[u][k] = ew.read(eb + (int)re[u][k]);
        ecur += (int)cnt[u];
        ew.ahead(ecur, tid);
      }
    }
    // The inverse of the U rows, off the chain.
    inverse(v, tm);
#pragma unroll
    for (int u = 0; u < U; ++u) st_row(o + (size_t)(t0 + u) * kLanes, tid, v[u]);
  }
#if MIC_DIRECT_RING
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Dynamic shared memory: each team's strip at the word offset of its
// descriptor (ring, tables, the escapes' ring, the column carry).
__global__ void __launch_bounds__(kThreads)
direct_groups_kernel(const DirectGroup* __restrict__ groups, const int4* __restrict__ blocks,
                     uint16_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t xbuf[kStrips][MIC_DIRECT_TEAM == 128 ? 2 * kMaxU * 4 : 1];
  const int id = threadIdx.x / kTeam;
  const int4 d = blocks[blockIdx.x * kStrips + id];
  if (d.x < 0) return;  // an idle team: the block holds fewer strips
  const DirectGroup& g = groups[d.x];
  Team tm{(int)threadIdx.x % kTeam, id, xbuf[id], 0};
  if (g.front == kAlias)
    decode_strip<kAlias>(g, d.y, d.z, out, tm);
  else if (g.front == kPacked)
    decode_strip<kPacked>(g, d.y, d.z, out, tm);
  else if (!g.tdev)
    decode_strip<kTwoTable>(g, d.y, d.z, out, tm);
  else
    decode_strip<kTwoTable, true>(g, d.y, d.z, out, tm);
}

}  // namespace

extern "C" {

// groups: DirectGroup[] and blocks: int4[n_blocks * 4] (group or -1,
// strip, shared-memory word offset, 0), both on the device; out: the flat
// buffer the groups' offsets index; smem_bytes: the dynamic shared memory
// of a block.
int mic_direct_decode_groups(const void* groups, const void* blocks, int n_blocks, void* out,
                             int smem_bytes, void* stream) {
  if (n_blocks <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, direct_groups_kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes <= 0 || (size_t)smem_bytes + fa.sharedSizeBytes > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(direct_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return (int)e;
  direct_groups_kernel<<<n_blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const DirectGroup*)groups, (const int4*)blocks, (uint16_t*)out);
  return (int)cudaGetLastError();
}

// Blocks of direct_groups_kernel resident per SM at smem_bytes of dynamic
// shared memory (a negative CUDA error on failure).
int mic_direct_occupancy(int smem_bytes) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(direct_groups_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, direct_groups_kernel, kThreads,
                                                      smem_bytes);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
