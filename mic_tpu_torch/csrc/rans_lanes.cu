// L-lane rANS decode of MICT strips for Hopper: the scan tier, for strips
// at any power-of-two lane count and FF 41 strips above tableLog 12, which
// the 128-lane kernels (rans_direct.cu, rans_rle.cu) do not take.  Every
// scan bucket of a decode plan runs in one launch (two where a plan holds
// strips of both forms below); the direct modes' inverse (zzd, vdd, pdd)
// runs in the same kernel, so no torch op follows them.
//
// lanes_groups_kernel replaces no Pallas kernel: mic_tpu runs this tier in
// plain XLA, mic_tpu/tpu/strips.py:decode_strip_batch_impl, its rans_one
// (the lax.scan over L-lane steps, :762), subst_one (the escape
// substitution, :784) and, for the direct modes, _post_one_strip's first
// three branches (:693-698: pipeline.zzd / vdd / pdd_inverse_device).  It
// computes exactly what they compute, per step of a strip:
//
//   slot = x & mask; sym = tsym[slot]; (f, b) = (tf, tb)[slot]
//   x' = f * (x >> tl) + b                       (u32, wrapping)
//
// (for an FF 41 strip of the warp form the same sym, f and b from its
// alias layout's 128 buckets, below)
//   active = t * L + lane < count
//   need = x' < 2^16 && active
//   x' = need ? x' << 16 | words[min(cursor + rank(need), W - 1)] : x'
//   cursor += total(need); x = active ? x' : x
//   out[t * L + lane] = sym, every lane, inactive ones included
//
// then, in stream order over the whole strip, every symbol equal to the
// strip's escape value (-1 for FF 57: none) takes the side stream's value
// at its escape rank, clipped to the side's last index; then, for a group
// with an inverse, the symbols zero-padded to width * strip_h go through
// it (post.py:post_batch, the same whole array): unzigzag, then the row
// prefix mod 2^16 restarted every width / L steps (zzd, pdd), then the
// column carry of width u16 values (vdd, pdd).
//
// What bounds it on this card: a strip is a serial chain of dependent
// steps (a 1024-step strip of 64 lanes moves 128 KB of pixels and ~57 KB
// of words), so a launch lasts its longest chain; the batch's bytes take
// tens of microseconds.  Two forms, chosen per strip by the host
// (tpu/scan_decode.py:LanesPacking, lanes <= WARP_LANES take the first):
//
// 1. The warp form (lanes_groups_kernel): a warp per strip, four strips
//    (teams) a block, as rans_direct.cu's direct_groups_kernel.  Thread j
//    holds LPT = max(1, L / 32) states, lanes j * LPT .. j * LPT + LPT - 1
//    (a strip under 32 lanes leaves its spare threads idle).  A step's
//    renorm ranks come from LPT __ballot_sync and __popc under
//    lanemask_lt, its total from the popcounts: no block barrier, no
//    shared-memory scan.  Words come from a ring in shared memory, chunk
//    c (C = max(L, 64) words) of the strip's stream at slot c & 7, filled
//    by cp.async kLead = 6 chunks ahead of the chunk of min(cursor, W - 1);
//    a step consumes at most L <= C words, so its reads lie in that chunk
//    and the next, which the ring holds, and the clipped index
//    min(cursor + rank, W - 1) reads the ring as it would device memory,
//    on damaged streams too.  The chain runs U steps (U * LPT <= 16) and
//    keeps their symbols; then, off the chain, the escapes of those rows
//    are counted the same way and read from a window of the side stream
//    in shared memory (1024 values, refilled with a wait where a batch's
//    reads leave it), and the inverse takes the rows: unzigzag, the row
//    prefix as U warp scans side by side, the column carry in shared
//    memory (each thread owns its columns: no sync).  The inverse is a
//    group field read at run time: one code path per lane count and front
//    end, chosen per strip.  An FF 41 strip whose group carries bucket
//    tables (tpu/scan_decode.py:build_lane_operands) reads its alias
//    layout's 128 buckets, 16 bytes each (alias_bucket_words), copied to
//    its team's shared memory in the wait of the ring's first chunks:
//      bkt = min(slot >> (tl - 7), 127); off = slot & (2^(tl-7) - 1)
//      off < t[bkt] ? (p, fp, sbp + off) : (a, fa, sba + off - t)
//    2 KB a strip at every tableLog 7-17, so a lookup is one 16-byte
//    shared read and a few selects where the slot tables (2^tl slots,
//    24 KB a strip at tl 12) were random reads through L1 and L2.  FF 57
//    strips (and an FF 41 strip without a bucket table) read the slot
//    tables from device memory through L1: two, tsym and tfb = freq << 16
//    | bias, where a group's freq and bias fit 16 bits, else three
//    (staging the slot tables in shared memory measured slower: 112 KB
//    blocks halve the blocks an SM; PERF.md has the numbers).
// 2. The block form (lanes_wide_kernel), symbols out, for strips past
//    WARP_LANES (up to 16,384 lanes): a block a strip, a thread a lane up
//    to 1024 threads (lanes j * 1024 + tid past that), one exclusive block
//    scan a step (two warp ballots and popcounts, the warps' totals, both
//    counts packed in one word, 16 bits each, scanned by warp 0, two named
//    barriers), every read from device memory; the torch post stage
//    follows it.
//
// Operands stay in their strip: the slot is masked to the strip's table
// (the host checks every table's span), the bucket index clips to 127,
// the word and escape indices clip
// to their rows, the ring and window copy only inside each row's padded
// stride (a multiple of 8 u16, so every copy is 16 bytes).
//
// The MIC_LANES_* macros select design points for
// scripts/lanes_design_points.py; the defaults are the design above (the
// ring and U = 4 each measured fastest in a plan's launch; past 256 lanes the warp form's step is slower than the block
// form's, but a fused bucket there still beats the block form and the
// torch post stage: PERF.md has the numbers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (mic_tpu_torch/_build.py).  The C entry points return
// cudaGetLastError() after their launch.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MIC_LANES_RING  // 0: words read from device memory after the count
#define MIC_LANES_RING 1
#endif
#ifndef MIC_LANES_U  // steps a batch (capped so that U * LPT <= 16)
#define MIC_LANES_U 4
#endif

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTeams = 4;          // strips (warps) a block of the warp form
constexpr int kSlots = 8;          // ring slots
constexpr int kLead = 6;           // chunks loaded ahead of the window's first
constexpr int kEscWindow = 1024;   // escape side-stream values held a strip
constexpr int kBuckets = 128;      // an alias layout's buckets (16 bytes each)
constexpr int kBucketBytes = 16 * kBuckets;
// warp_strip's front ends: the slot tables (two or three), or the buckets
constexpr int kTwoTables = 0, kThreeTables = 1, kAliasBuckets = 2;
static_assert(kLead + 2 <= kSlots, "a load must not overwrite a chunk still read");
static_assert(MIC_LANES_U == 1 || MIC_LANES_U == 2 || MIC_LANES_U == 4 || MIC_LANES_U == 8,
              "U is 1, 2, 4 or 8");

// One bucket (tpu/scan_decode.py:_LANE_GROUP_DESC): operand pointers, the
// element offset of its output in the launch's flat buffer, and its shape.
// inv: 0 symbols out (out_steps = steps), 1 zzd, 2 vdd, 3 pdd (out_steps =
// width * strip_h / L, ws = width / L).  W and E are the clip bounds of the
// word and escape indices, wstride and estride the rows' padded strides.
// alias: some strip has a bucket table (aoff[s] >= 0), and every team of
// the group holds kBucketBytes for one; abk and aoff are null otherwise.
struct LaneGroup {
  const uint32_t* init;     // [S, L] initial states
  const uint16_t* words;    // [S, wstride] renorm words, zero past each stream
  const uint16_t* tsym;     // [N] every strip's slot symbols, at toff[s]
  const uint32_t* tfb;      // [N] freq << 16 | bias (form 0), or freq (form 1)
  const uint32_t* tb;       // [N] bias (form 1; form 0: tfb again)
  const int32_t* toff;      // [S] a strip's table offset
  const int32_t* tls;       // [S] a strip's tableLog, 0-17
  const int32_t* counts;    // [S] symbols
  const int32_t* escv;      // [S] escape value, -1 for none
  const uint16_t* esides;   // [S, estride] escape side streams
  const uint4* abk;         // [M, 128] FF 41 strips' alias buckets
  const int32_t* aoff;      // [S] a strip's bucket table in abk, -1 for none
  int64_t off;
  int32_t lanes, W, E, steps, form, inv, out_steps, ws, width, wstride, estride, esc;
  int32_t alias;
  int32_t pad;  // 160 bytes
};
static_assert(sizeof(LaneGroup) == 160, "tpu/scan_decode.py:_LANE_GROUP_DESC");

// The warp form's dynamic shared memory, addressed by byte offsets.
extern __shared__ __align__(16) uint8_t smem_b[];

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  return lt;
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t sym) {
  const int si = (int)sym;
  return (uint32_t)((si >> 1) ^ (-(si & 1)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n u16 values (n a multiple of 8) from src to dst, 16 bytes a copy, the
// copies past `limit` values of src skipped.
__device__ __forceinline__ void copy_u16(uint16_t* dst, const uint16_t* src, int n, int limit,
                                         int ln) {
  for (int i = 8 * ln; i < n; i += 8 * 32)
    if (i < limit) cp_async16(dst + i, src + i);
}

// Exclusive ranks, in lane order over the strip's lanes (thread-major,
// LPT contiguous lanes a thread), of the lanes whose flag is set; returns
// the count.
template <int LPT>
__device__ __forceinline__ uint32_t warp_ranks(const bool (&f)[LPT], uint32_t (&r)[LPT]) {
  const unsigned lt = lanemask_lt();
  uint32_t below = 0, run = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const unsigned v = __ballot_sync(kFull, f[k]);
    below += __popc(v & lt);
    run += __popc(v);
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    r[k] = below;
    below += f[k];
  }
  return run;
}

// LPT u16 values at p (2 * LPT-byte aligned; shared or device memory) in
// and out, in the widest accesses that fit.
template <int LPT>
__device__ __forceinline__ void ld_lanes(const uint16_t* p, uint32_t (&v)[LPT]) {
  if constexpr (LPT == 1) {
    v[0] = p[0];
  } else if constexpr (LPT == 2) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
    v[0] = q & 0xFFFFu;
    v[1] = q >> 16;
  } else if constexpr (LPT == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x & 0xFFFFu, v[1] = q.x >> 16, v[2] = q.y & 0xFFFFu, v[3] = q.y >> 16;
  } else {
#pragma unroll
    for (int h = 0; h < LPT / 8; ++h) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[h];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[8 * h + 2 * i] = w[i] & 0xFFFFu;
        v[8 * h + 2 * i + 1] = w[i] >> 16;
      }
    }
  }
}

template <int LPT>
__device__ __forceinline__ void st_lanes(uint16_t* p, const uint32_t (&v)[LPT]) {
  if constexpr (LPT == 1) {
    p[0] = (uint16_t)v[0];
  } else if constexpr (LPT == 2) {
    *reinterpret_cast<uint32_t*>(p) = __byte_perm(v[0], v[1], 0x5410);
  } else if constexpr (LPT == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
  } else {
#pragma unroll
    for (int h = 0; h < LPT / 8; ++h) {
      const uint32_t* w = v + 8 * h;
      reinterpret_cast<uint4*>(p)[h] =
          make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                     __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
    }
  }
}

// The shared-memory layout of one strip of the warp form, in bytes from
// its team's offset (tpu/scan_decode.py:_team_bytes counts the same): the
// bucket table (kBucketBytes, groups with bucket tables), the word ring
// (kSlots chunks of C u16), the escape window (kEscWindow u16, groups with
// escapes), the column carry (width u16, rounded up to 16 bytes; vdd and
// pdd).
__device__ __forceinline__ int ring_chunk(int L) { return L > 64 ? L : 64; }

// One strip of the warp form.  FRONT: kTwoTables, kThreeTables (freq and
// bias apart) or kAliasBuckets; a template argument, so each step carries
// only its own front end's reads.
template <int LPT, int FRONT>
__device__ __forceinline__ void warp_strip(const LaneGroup& g, int s, int sm,
                                           uint16_t* __restrict__ out) {
  constexpr int U = MIC_LANES_U * LPT <= 16 ? MIC_LANES_U : 16 / LPT;
  constexpr bool form = FRONT == kThreeTables;
  const int ln = threadIdx.x & 31;
  const int L = g.lanes, W = g.W, E = g.E, inv = g.inv;
  const int lane0 = ln * LPT;               // the thread's first lane
  const bool valid = LPT > 1 || lane0 < L;  // false only for the spare threads of L < 32
  const int tl = g.tls[s];
  const uint32_t mask = (1u << tl) - 1u;
  const uint32_t ksh = (uint32_t)max(tl - 7, 0);  // a bucket's slots: 2^ksh (tl >= 7 here)
  const uint32_t kmask = (1u << ksh) - 1u;
  const long long count = g.counts[s];
  const int escv = g.escv[s];
  const bool esc = g.esc && escv >= 0;
  const long long to = g.toff[s];
  const uint16_t* tsym = g.tsym + to;
  const uint32_t* tfb = g.tfb + to;
  const uint32_t* tb = g.tb + to;
  const uint16_t* wrow = g.words + (long long)s * g.wstride;
  const uint16_t* erow = g.esides + (long long)s * g.estride;
  const int C = ring_chunk(L);  // a power of two
  const int cshift = 31 - __clz(C);
  uint4* bk = reinterpret_cast<uint4*>(smem_b + sm);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_b + sm + (g.alias ? kBucketBytes : 0));
  uint16_t* ewin = ring + kSlots * C;
  uint16_t* carry = ewin + (g.esc ? kEscWindow : 0);
  const int ring_mask = kSlots * C - 1;

  uint32_t x[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) x[k] = valid ? g.init[(long long)s * L + lane0 + k] : 0u;

  // The bucket table, chunks 0..kLead of the words, the escape window's
  // first values, the column carry at 0; waited for before the first step.
  if (FRONT == kAliasBuckets) {
    const uint4* src = g.abk + (long long)g.aoff[s] * kBuckets;
    for (int i = ln; i < kBuckets; i += 32) cp_async16(bk + i, src + i);
  }
  const int last = (W - 1) >> cshift;  // every word read lies in chunks 0..last
  int next = min(kLead + 1, last + 1);
#if MIC_LANES_RING
  for (int c = 0; c < next; ++c) copy_u16(ring + (c & (kSlots - 1)) * C, wrow + c * C, C,
                                          g.wstride - c * C, ln);
#endif
  int w0 = 0;  // the escape window holds side values w0 .. w0 + kEscWindow - 1
  if (esc) copy_u16(ewin, erow, kEscWindow, g.estride, ln);
  if (inv >= 2)
    for (int i = ln; i < (g.width + 1) / 2; i += 32) reinterpret_cast<uint32_t*>(carry)[i] = 0u;
  cp_commit();
  cp_wait_all();
  __syncwarp();

  const int n_out = g.out_steps;
  const int chain = min(g.steps, n_out);  // steps past it are zero symbols
  const int ws = g.ws;
  uint16_t* o = out + g.off + (long long)s * n_out * L + lane0;
  uint32_t cursor = 0, rowc = 0;
  int ecur = 0, pos = 0;  // escapes taken; the step's place in its row
#pragma unroll 1
  for (int t0 = 0; t0 < n_out; t0 += U) {
    uint32_t v[U][LPT];
    // The chain: U steps of the states, their symbols into v.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t >= chain) {
#pragma unroll
        for (int k = 0; k < LPT; ++k) v[u][k] = 0u;
        continue;
      }
      // lanes below rem are active
      const int rem = (int)max(min(count - (long long)t * L, (long long)L), 0LL);
      uint32_t xn[LPT], rn[LPT];
      bool need[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const uint32_t slot = x[k] & mask;
        uint32_t f, b, sy;
        if constexpr (FRONT == kAliasBuckets) {  // scan_decode.alias_bucket_words' fields
          const uint4 q = bk[min(slot >> ksh, (uint32_t)(kBuckets - 1))];
          const uint32_t off = slot & kmask;
          const bool is_p = off < (q.x >> 18);
          const uint32_t bw = is_p ? q.y : q.w;
          f = (is_p ? q.x : q.z) & 0x3FFFFu;
          b = (bw + off) & 0x1FFFFu;
          sy = (bw >> 17) | ((q.z >> (is_p ? 3 : 4)) & 0x8000u);
        } else {
          const uint32_t fb = __ldg(tfb + slot);
          b = form ? __ldg(tb + slot) : fb & 0xFFFFu;
          sy = __ldg(tsym + slot);
          f = form ? fb : fb >> 16;
        }
        v[u][k] = valid ? sy : 0u;
        xn[k] = f * (x[k] >> tl) + b;
        const bool act = lane0 + k < rem;  // never for a spare thread: rem <= L
        need[k] = act && xn[k] < 65536u;
        if (!act) xn[k] = x[k];
      }
      const uint32_t tot = warp_ranks<LPT>(need, rn);
#if MIC_LANES_RING
      // a chunk committed by step t - kLead or earlier has landed
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
      __syncwarp();
#endif
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const uint32_t i = min(cursor + rn[k], (uint32_t)(W - 1));
#if MIC_LANES_RING
        const uint32_t w = ring[i & ring_mask];
#else
        const uint32_t w = need[k] ? __ldg(wrow + i) : 0u;
#endif
        x[k] = need[k] ? (xn[k] << 16) | w : xn[k];
      }
      cursor += tot;
#if MIC_LANES_RING
      // The window's first chunk moves by at most one a step: load the
      // chunk kLead past it; the slot it takes held a chunk 2 or more
      // below the window, which nobody reads again.
      const int want = min((int)(min(cursor, (uint32_t)(W - 1)) >> cshift) + kLead, last);
      if (want >= next) {
        copy_u16(ring + (next & (kSlots - 1)) * C, wrow + next * C, C, g.wstride - next * C,
                 ln);
        ++next;
      }
      cp_commit();
#endif
    }
    // The escapes of the U rows, off the chain, in stream order.
    if (esc) {
      bool e[U][LPT];
      uint32_t re[U][LPT], cnt[U];
      int total = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = t0 + u < chain;
#pragma unroll
        for (int k = 0; k < LPT; ++k) e[u][k] = live && valid && (int)v[u][k] == escv;
        cnt[u] = warp_ranks<LPT>(e[u], re[u]);
        total += (int)cnt[u];
      }
      if (total) {
        const int lo = min(ecur, E - 1), hi = min(ecur + total - 1, E - 1);
        if (hi >= w0 + kEscWindow) {  // refill the window at lo, then wait
          __syncwarp();
          w0 = lo & ~7;
          copy_u16(ewin, erow + w0, kEscWindow, g.estride - w0, ln);
          cp_commit();
          cp_wait_all();
          __syncwarp();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < LPT; ++k)
            if (e[u][k]) v[u][k] = ewin[min(ecur + (int)re[u][k], E - 1) - w0];
          ecur += (int)cnt[u];
        }
      }
    }
    // The inverse of the U rows, off the chain.
    int pu[U];  // each row's step in its image row
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pu[u] = pos;
      if (++pos >= ws) pos = 0;
    }
    if (inv) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < LPT; ++k) v[u][k] = unzigzag(v[u][k]);
      if (inv & 1) {  // zzd, pdd: the row prefix, restarted at each image row
        uint32_t sum[U], excl[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 1; k < LPT; ++k) v[u][k] += v[u][k - 1];
          sum[u] = v[u][LPT - 1];
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint32_t y = __shfl_up_sync(kFull, sum[u], d);
            if (ln >= d) sum[u] += y;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          excl[u] = sum[u] - v[u][LPT - 1];
          const uint32_t row_total = __shfl_sync(kFull, sum[u], 31);
          if (pu[u] == 0) rowc = 0;
#pragma unroll
          for (int k = 0; k < LPT; ++k) v[u][k] += excl[u] + rowc;
          rowc += row_total;
        }
      }
      if (inv >= 2 && valid) {  // vdd, pdd: the column carry; a thread owns its columns
#pragma unroll
        for (int u = 0; u < U; ++u) {
          uint16_t* cp = carry + pu[u] * L + lane0;
          uint32_t prev[LPT];
          ld_lanes<LPT>(cp, prev);
#pragma unroll
          for (int k = 0; k < LPT; ++k) v[u][k] += prev[k];
          st_lanes<LPT>(cp, v[u]);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u < n_out) st_lanes<LPT>(o + (long long)(t0 + u) * L, v[u]);
    }
  }
#if MIC_LANES_RING
  cp_wait_all();
#endif
}

// A strip's front end: its bucket table where it has one, else its
// group's slot-table form.
template <int LPT>
__device__ __forceinline__ void warp_strip_any(const LaneGroup& g, int3 d, uint16_t* out) {
  if (g.alias && g.aoff[d.y] >= 0)
    warp_strip<LPT, kAliasBuckets>(g, d.y, d.z, out);
  else if (g.form)
    warp_strip<LPT, kThreeTables>(g, d.y, d.z, out);
  else
    warp_strip<LPT, kTwoTables>(g, d.y, d.z, out);
}

// The warp form: team i of block b decodes the strip of teams[b * 4 + i]
// = (group or -1, strip, shared byte offset).  No block barrier: a team's
// warp syncs only itself.  4 blocks an SM at least (128 registers a
// thread at most), the residency every front end keeps.
__global__ void __launch_bounds__(kTeams * 32, 4)
lanes_groups_kernel(const LaneGroup* __restrict__ groups, const int3* __restrict__ teams,
                    uint16_t* __restrict__ out) {
  const int3 d = teams[blockIdx.x * kTeams + (threadIdx.x >> 5)];
  if (d.x < 0) return;  // an idle team: the block holds fewer strips
  const LaneGroup& g = groups[d.x];
  switch (g.lanes <= 32 ? 1 : g.lanes >> 5) {
    case 1: warp_strip_any<1>(g, d, out); break;
    case 2: warp_strip_any<2>(g, d, out); break;
    case 4: warp_strip_any<4>(g, d, out); break;
    case 8: warp_strip_any<8>(g, d, out); break;
    case 16: warp_strip_any<16>(g, d, out); break;
    default: break;  // the host sends no wider strip to this form
  }
}

// ---- the block form: symbols out, lanes past the warp form's ----------

// A named barrier over the first n threads of the block (n a multiple of
// 32): the warps past a strip's lanes leave the block at its start.
__device__ __forceinline__ void bar_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

template <int LPT>
__global__ void __launch_bounds__(1024) lanes_wide_kernel(const LaneGroup* __restrict__ groups,
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
  const uint16_t* words = g.words + (int64_t)s * g.wstride;
  const uint16_t* side = g.esides + (int64_t)s * g.estride;
  const int64_t to = g.toff[s];
  const uint16_t* tsym = g.tsym + to;
  const uint32_t* tfb = g.tfb + to;
  const uint32_t* tb = g.tb + to;
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
int launch_wide(const void* groups, const void* blocks, int n_blocks, void* out, int threads,
                void* stream) {
  lanes_wide_kernel<LPT><<<n_blocks, threads, 0, (cudaStream_t)stream>>>(
      (const LaneGroup*)groups, (const int2*)blocks, (uint16_t*)out);
  return (int)cudaGetLastError();
}

template <typename K>
int shape_of(K kernel, int threads, int smem, int* res) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  res[0] = (int)fa.sharedSizeBytes + smem;
  res[2] = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[1], kernel, threads, smem);
}

}  // namespace

extern "C" {

// The warp form.  groups: LaneGroup[] and teams: int3[n_blocks * 4], both
// on the device; out: the flat buffer the groups' offsets index;
// smem_bytes: a block's dynamic shared memory.
int mic_lanes_decode_groups(const void* groups, const void* teams, int n_blocks, void* out,
                            int smem_bytes, void* stream) {
  if (n_blocks <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes <= 0 || smem_bytes > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lanes_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return (int)e;
  lanes_groups_kernel<<<n_blocks, kTeams * 32, smem_bytes, (cudaStream_t)stream>>>(
      (const LaneGroup*)groups, (const int3*)teams, (uint16_t*)out);
  return (int)cudaGetLastError();
}

// The block form.  blocks: int2[n_blocks] (group, strip); threads: a
// block's threads, a multiple of 32 up to 1024; lpt: lanes a thread, 1-16.
int mic_lanes_decode_wide(const void* groups, const void* blocks, int n_blocks, void* out,
                          int threads, int lpt, void* stream) {
  if (n_blocks <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  switch (lpt) {
    case 1: return launch_wide<1>(groups, blocks, n_blocks, out, threads, stream);
    case 2: return launch_wide<2>(groups, blocks, n_blocks, out, threads, stream);
    case 4: return launch_wide<4>(groups, blocks, n_blocks, out, threads, stream);
    case 8: return launch_wide<8>(groups, blocks, n_blocks, out, threads, stream);
    case 16: return launch_wide<16>(groups, blocks, n_blocks, out, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A launch's shape: out (int[3]) gets its shared bytes a block (static and
// dynamic), its blocks resident on one SM and its registers a thread.
// wide 0: the warp form at smem_bytes of dynamic shared memory (threads,
// lpt unused); 1: the block form at `threads` and `lpt`.  Returns a CUDA
// error.
int mic_lanes_shape(int wide, int threads, int lpt, int smem_bytes, int* out) {
  if (!wide) return shape_of(lanes_groups_kernel, kTeams * 32, smem_bytes, out);
  switch (lpt) {
    case 1: return shape_of(lanes_wide_kernel<1>, threads, 0, out);
    case 2: return shape_of(lanes_wide_kernel<2>, threads, 0, out);
    case 4: return shape_of(lanes_wide_kernel<4>, threads, 0, out);
    case 8: return shape_of(lanes_wide_kernel<8>, threads, 0, out);
    case 16: return shape_of(lanes_wide_kernel<16>, threads, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
