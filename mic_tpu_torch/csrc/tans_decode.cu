// Interleaved tANS decode of the reference's entropy streams for Hopper.
//
// tans_groups_kernel replaces mic_tpu/tpu/pallas_tans.py:_kernel_tans
// (wrapper tans_decode_pallas): N-state interleaved tANS (magic FF 02 / 04
// / 84, N = 2 / 4 / 8) and, through an rANS decode table, FF 08.  The
// streams are reverse bitstreams read at bit granularity with one bit
// cursor per stream.  Per step, state j < N of a stream:
//   pk   = tpk[x]                       (rank << 19 | newState << 5 | nb)
//   sym  = alpha[rank] & 0xFFFF         -> out[t * N + j] (0 if inactive)
//   cum  = inclusive sum of nb over states 0..j (inactive ones: nb = 0)
//   x'   = newState + bits [pos - cum, pos - cum + nb) of the stream
//   pos -= cum of state N - 1
// where a state is active while t * N + j < count.
//
// What bounds it on this card: a stream is one serial chain of dependent
// steps (table read -> bit count -> bit read -> next state), 8 to 104 bits
// a step.  The bytes the streams move take tens of microseconds at the
// memory rate; a chain of 33,000 steps takes a millisecond however few
// bytes it reads, so the bytes bound is not reachable.  A batch lasts its
// longest chain, or the sum of all chains over the streams the card runs
// at full speed at once.  A dependent integer instruction costs about 5
// cycles here, a shared-memory read or a warp shuffle 25-30, a read of
// device memory through L1 more; so the design counts what sits in the
// chain, and the five points of the redesign came out as follows
// (scripts/tans_design_points.py times them; PERF.md has the numbers):
//
// 1. The words come from shared memory, and in hot rows (below) from
//    registers.  Each warp keeps a ring of four 128-word blocks of its
//    stream, filled with 16-byte cp.async copies one block ahead of the
//    cursor (which only moves down).  The ring always holds the two blocks
//    of the Pallas kernel's 256-word window, so every read, clamped or
//    not, is a shared-memory read.
// 2. The lane scan is gone, not replaced.  N lanes with one state each
//    need log2 N rounds of shuffles for the prefix sum of nb, and votes
//    (one __ballot_sync per bit of nb and popc under each lane's mask)
//    measured slower still.  Instead every lane of the warp decodes all N
//    states of its stream, one after another, from a register that holds
//    the bits below the cursor and is shifted by each state's nb: nothing
//    crosses lanes, and a state's chain is one LDS, one funnel shift and
//    one multiply-add.
// 3. Every stream takes shared memory for its own table and alphabet
//    (sizes[s]: at least 128 words each), not the launch's largest, and a
//    block holds several warps, one stream each.  The host packs streams
//    into blocks, longest chains first, so that a block's streams end
//    together; by default 4 warps a block and one block per SM, a stream
//    per warp scheduler, because with more the streams slow each other
//    (every lane of a warp issues every instruction of its stream's step)
//    by more than a batch, which lasts its longest chains, gains.  The operands pad tables and
//    alphabets with zeros and a read past either gives 0 already, so the
//    result is the same bit for bit.
// 4. The streams of every (coder, N) group run in one grid: a warp's
//    descriptor names its group, stream and shared-memory offset, and the
//    body is a __device__ function templated on N behind a switch that is
//    uniform over the block (the host puts one group in a block).
// 5. A step stores the upper halves of its N pk words (the ranks) into a
//    row buffer in shared memory with one store; after the row's 128 / N
//    steps the lanes look up the alphabet and write the row with one
//    coalesced 8-byte store each, so neither the alphabet read nor
//    scattered 2-byte stores sit in the step.
//
// A warp stops once its own count is decoded, zeroing its remaining rows.
//
// Out-of-range guards, shared with the plain version in
// mic_tpu_torch/tpu/tans_decode.py (valid operands never need the first
// two): a state at or past the stream's table and a rank at or past its
// alphabet read 0; each output row of 128 / N steps reads through the
// Pallas kernel's 256-word window, whose first block is
// max(pos - 128 * tl - 64, 0) >> 12, clamped to wb - 2, and every word
// index clamps into it ([base, base + 254] and the word after), so reads
// below bit 0 (after a state's last symbol, or from an over-claimed count)
// and past the stream stay in the array.  A row moves the cursor by less
// than one block (128 * 31 bits), so the window falls by at most one
// block a row and the ring's prefetch of the block below always covers
// it.  No shift reaches 32: the funnel shifts take their amount mod 32 and
// nb < 32.  Rows take the hot form only where a warp-uniform test shows
// that none of these guards can act in them (Row, below).
//
// The MIC_TANS_* macros select other forms of the step for
// scripts/tans_design_points.py; the defaults are the design above.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef MIC_TANS_HOT  // 0: every row takes the general form
#define MIC_TANS_HOT 1
#endif
#ifndef MIC_TANS_PIPE_MAX_N  // the largest N whose hot rows load the window a step ahead
#define MIC_TANS_PIPE_MAX_N 2
#endif

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxGroups = 8;
constexpr int kMaxWarps = 8;
constexpr int kRingWords = 512;  // four 128-word blocks of the stream
constexpr int kRingPad = 8;      // the ring's first words again, so that a short run never wraps
constexpr int kRowWords = 64;    // one output row: 128 u16 (the upper halves of its pk words)
// Words of a stream's shared memory before its table (tans_decode.py:
// STREAM_FIXED_BYTES): ring, pad, row buffer.
constexpr int kFixedWords = kRingWords + kRingPad + kRowWords;

// One (coder, N) group's operands (tans_decode.py:_GROUP_DESC, 80 bytes).
struct GroupDesc {
  const uint32_t* init;
  const int32_t* pos;
  const int32_t* cnt;
  const uint32_t* tpk;
  const uint32_t* alpha;
  const uint32_t* words;
  const int32_t* sizes;  // [R, 2]: the stream's own table and alphabet words
  int32_t ts, asz, wb, steps, table_log, n_states;
};

struct Outs {
  uint16_t* p[kMaxGroups];
};

// Block b of the stream (128 words) into its ring slot, 16 bytes a lane;
// the first slot's first words also into the pad behind the ring.
__device__ __forceinline__ void stage_block(uint32_t* ring, const uint32_t* w, int b, int lane) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(ring + ((b & 3) << 7) + 4 * lane);
  const uint32_t* src = w + ((size_t)b << 7) + 4 * lane;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  if ((b & 3) == 0 && lane < kRingPad / 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 4 * kRingWords),
                 "l"(src)
                 : "memory");
}

// A word of shared memory at a 32-bit shared address.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// a * 4 + b as one instruction the compiler cannot split or re-associate:
// b is ready long before a, and a sits in the chain.
__device__ __forceinline__ uint32_t mad4(uint32_t a, uint32_t b) {
  uint32_t v;
  asm("mad.lo.u32 %0, %1, 4, %2;\n" : "=r"(v) : "r"(a), "r"(b));
  return v;
}

// One 128-symbol output row of a stream, N states, SPR = 128 / N steps.
// Every lane of the warp computes the same values (the loads broadcast);
// the lanes divide only the copies, the flush and the zero fill.
//
// Hot form (every row of an honest stream but its last ones).  The row is
// whole (all 128 symbols below the count), the table is closed (every
// entry leads to a state inside it, so no range check), N lanes of the
// table's largest nb stay inside BW = N / 2 words, and no cursor of the
// row can reach the window's clamp.  Then a step is, per state j in order:
//   pk_j  = table[x_j]                      one LDS at an address kept ready
//   val_j = top nb_j bits of buf            one funnel shift by pk_j (its low 5 bits)
//   buf <<= nb_j                            funnel shifts, off the state's own chain
//   addr  = &table[newState_j] + 4 val_j    one multiply-add
// and the next step's entry is read right there, before the later states
// of this step, so a state's chain is LDS, a few shifts, one add; no lane
// exchange, no scan, no mask.  buf holds the 32 BW bits below the cursor.
// Up to N = MIC_TANS_PIPE_MAX_N it is built at the top of a step from
// 2 BW + 1 ring words that were loaded a step earlier, for the cursor of
// that step: the cursor has fallen by at most BW words since, so picking
// BW + 1 of them by the word distance d and one funnel shift by the bit
// offset give buf a few instructions after the cursor is known, and the
// shared-memory latency of the window never meets the chain.  Above it
// (N = 8: nine loads and twenty selects a step) the step loads its BW + 1
// words itself: once every lane computes the same step, the warp is bound
// by the instructions it issues as much as by its chain.
template <int N>
struct Row {
  static constexpr int SPR = 128 / N;
  static constexpr int BW = N / 2;
  static constexpr bool PIPE = N <= MIC_TANS_PIPE_MAX_N;
  static constexpr int L = PIPE ? 2 * BW + 1 : BW + 1;

  // raw[i] = word k - (L - 1) + i of the ring.
  static __device__ __forceinline__ void load_raw(uint32_t (&raw)[L], uint32_t ring_sa, int k) {
    const uint32_t a = ring_sa + 4u * (uint32_t)((k - (L - 1)) & (kRingWords - 1));  // pad: no wrap
#pragma unroll
    for (int i = 0; i < L; ++i) raw[i] = lds(a + 4 * i);
  }

  static __device__ __forceinline__ void hot(uint32_t (&x)[N], int& pos, uint32_t tpk_sa,
                                             uint32_t ring_sa, uint32_t row_sa) {
    uint32_t addr[N], pk[N], raw[L];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      addr[j] = tpk_sa + 4u * x[j];
      pk[j] = lds(addr[j]);
    }
    int kp = pos >> 5;
    if constexpr (PIPE) load_raw(raw, ring_sa, kp);
#pragma unroll 2
    for (int t = 0; t < SPR; ++t) {
      const int k = pos >> 5;
      uint32_t win[BW + 1], buf[BW], next[L];
      if constexpr (PIPE) {
        // The words k - BW .. k of this cursor out of those held for kp.
        const int d = kp - k;  // 0 <= d <= BW
#pragma unroll
        for (int i = 0; i <= BW; ++i) {
          win[i] = raw[BW + i];
#pragma unroll
          for (int c = 1; c <= BW; ++c) win[i] = d >= c ? raw[BW + i - c] : win[i];
        }
        load_raw(next, ring_sa, k);
      } else {
        load_raw(win, ring_sa, k);
      }
#pragma unroll
      for (int i = 0; i < BW; ++i)  // buf[i] = bits [pos - 32 (i + 1), pos - 32 i)
        buf[i] = __funnelshift_r(win[BW - 1 - i], win[BW - i], (uint32_t)pos);
      uint32_t total = 0, halves[N / 2], prev = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t cur = pk[j];
        const uint32_t val = __funnelshift_l(buf[0], 0u, cur);  // top nb bits; 0 for nb = 0
        addr[j] = mad4(val, tpk_sa + ((cur >> 3) & 0xFFFCu));
        pk[j] = lds(addr[j]);  // the next step's entry, asked for as early as its address exists
        total += cur & 31u;
        // The states after j take at most 16 bits each (N maxnb <= 32 BW):
        // words 0 .. (N - j) / 2 - 1 go on, fed from the word below while
        // that one is still kept, (N - j + 1) / 2 words being valid now.
#pragma unroll
        for (int i = 0; i < (N - j) / 2; ++i)
          buf[i] = __funnelshift_l(i + 1 < (N - j + 1) / 2 ? buf[i + 1] : 0u, buf[i], cur);
        if (j & 1) halves[j / 2] = __byte_perm(prev, cur, 0x7632);
        prev = cur;
      }
      pos -= (int)total;
      store_halves(row_sa + 2u * N * t, halves);
      if constexpr (PIPE) {
        kp = k;
#pragma unroll
        for (int i = 0; i < L; ++i) raw[i] = next[i];
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = (addr[j] - tpk_sa) >> 2;
  }

  // The upper halves of a step's N pk words (rank << 3 and above), one
  // store of 2 N bytes.
  static __device__ __forceinline__ void store_halves(uint32_t sa, const uint32_t (&h)[N / 2]) {
    if constexpr (N == 2) {
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sa), "r"(h[0]) : "memory");
    } else if constexpr (N == 4) {
      asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(sa), "r"(h[0]), "r"(h[1])
                   : "memory");
    } else {
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(sa), "r"(h[0]), "r"(h[1]),
                   "r"(h[2]), "r"(h[3])
                   : "memory");
    }
  }

  // The general form: any row, any operands.  Per state: the range check
  // of the state, the active test, two words through the window's clamp.
  static __device__ __forceinline__ void cold(uint32_t (&x)[N], int& pos, const uint32_t* s_tpk,
                                              uint32_t own_ts, const uint32_t* ring, int base,
                                              int first, int count, uint32_t row_sa) {
    for (int t = 0; t < SPR; ++t) {
      uint32_t cum = 0, halves[N / 2], prev = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t pk = x[j] < own_ts ? s_tpk[x[j]] : 0u;
        const uint32_t nb = first + t * N + j < count ? pk & 31u : 0u;
        cum += nb;
        const int start = pos - (int)cum;
        const int idx = base + min(max((start >> 5) - base, 0), 254);
        const uint32_t* rp = ring + (idx & (kRingWords - 1));  // pad: the word after, no wrap
        const uint32_t lo = rp[0], hi = rp[1];
        // A state past the count stays past it, adds nb = 0 and emits 0:
        // it needs no freeze.
        x[j] = ((pk >> 5) & 0x3FFFu) + (__funnelshift_r(lo, hi, (uint32_t)start) & ~(kFull << nb));
        if (j & 1) halves[j / 2] = __byte_perm(prev, pk, 0x7632);
        prev = pk;
      }
      pos -= (int)cum;
      store_halves(row_sa + 2u * N * t, halves);
    }
  }
};

template <int N>
__device__ void decode_stream(const GroupDesc& g, uint16_t* __restrict__ out, int s,
                              uint32_t* pool, int lane) {
  using R = Row<N>;
  constexpr int SPR = R::SPR, BW = R::BW;
  uint32_t* ring = pool;
  uint32_t* rowbuf = pool + kRingWords + kRingPad;
  uint32_t* s_tpk = pool + kFixedWords;
  const int own_ts = g.sizes[2 * s], own_asz = g.sizes[2 * s + 1];
  uint32_t* s_alpha = s_tpk + own_ts;

  // The stream's own table and alphabet (multiples of 128 words, rows 16-byte
  // aligned); on the way the table's largest nb and the largest state any
  // of its entries leads to (newState + 2^nb - 1).
  uint32_t maxnb = 0, reach = 0;
  auto top = [](uint32_t pk) { return ((pk >> 5) & 0x3FFFu) + ~(kFull << (pk & 31u)); };
  {
    const uint4* src = reinterpret_cast<const uint4*>(g.tpk + (size_t)s * g.ts);
    uint4* dst = reinterpret_cast<uint4*>(s_tpk);
#pragma unroll 4
    for (int i = lane; i < own_ts / 4; i += 32) {
      const uint4 v = __ldg(src + i);
      dst[i] = v;
      maxnb = max(max(maxnb, v.x & 31u), max(max(v.y & 31u, v.z & 31u), v.w & 31u));
      reach = max(max(reach, top(v.x)), max(max(top(v.y), top(v.z)), top(v.w)));
    }
    src = reinterpret_cast<const uint4*>(g.alpha + (size_t)s * g.asz);
    dst = reinterpret_cast<uint4*>(s_alpha);
#pragma unroll 4
    for (int i = lane; i < own_asz / 4; i += 32) dst[i] = __ldg(src + i);
  }
  maxnb = __reduce_max_sync(kFull, maxnb);
  reach = __reduce_max_sync(kFull, reach);
  __syncwarp();

  const uint32_t* w = g.words + (size_t)s * g.wb * 128;
  uint16_t* o = out + (size_t)s * g.steps * N;
  const int steps = g.steps, table_log = g.table_log;
  const int count = g.cnt[(size_t)s * 128];  // int32 compare, as the Pallas kernel's
  const int max_base = (g.wb - 2) * 128;
  const uint32_t tpk_sa = (uint32_t)__cvta_generic_to_shared(s_tpk);
  const uint32_t ring_sa = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t row_sa = (uint32_t)__cvta_generic_to_shared(rowbuf);
  uint32_t x[N];
  bool closed = reach < (uint32_t)own_ts;  // with the initial states inside the table too
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = g.init[(size_t)s * 128 + j];
    closed = closed && x[j] < (uint32_t)own_ts;
  }
  // N lanes of at most maxnb bits stay inside BW words; closed and narrow
  // are what the hot rows need of the table.
  const bool narrow = MIC_TANS_HOT && closed && N * maxnb <= 32u * BW;
  int pos = g.pos[(size_t)s * 128];
  int have_lo = INT_MAX;  // lowest block in the ring; blocks up to the window's are there too
  for (int t0 = 0; t0 < steps; t0 += SPR) {
    if (t0 * N >= count) {
      // Nothing is left to decode (count is the warp's own, so the exit is
      // warp-uniform): zero the remaining rows, 8 symbols a store (each
      // row starts 256-byte aligned).
      uint4* o4 = reinterpret_cast<uint4*>(o + (size_t)t0 * N);
      for (int i = lane; i < (steps - t0) * N / 8; i += 32) o4[i] = make_uint4(0, 0, 0, 0);
      return;
    }
    const int low = max(pos - 128 * table_log - 64, 0);
    const int base = min((low >> 12) << 7, max_base);
    {
      // The window's blocks B and B + 1 must be in the ring before this
      // row reads; block B - 1 is asked for now and waited for a row later.
      const int B = base >> 7;
      const bool all = have_lo > B;  // the first row
      if (all) {
        stage_block(ring, w, B + 1, lane);
        stage_block(ring, w, B, lane);
        have_lo = B;
      }
      if (have_lo > max(B - 1, 0)) stage_block(ring, w, --have_lo, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (all) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      }
      __syncwarp();
    }
    // The row's cursors lie in (pos - 128 maxnb, pos]; a step at cursor p
    // needs words (p >> 5) - BW .. p >> 5.
    if (narrow && (t0 + SPR) * N <= count && ((pos - 128 * (int)maxnb) >> 5) - BW >= base &&
        (pos >> 5) <= base + 254) {
      R::hot(x, pos, tpk_sa, ring_sa, row_sa);
    } else {
      R::cold(x, pos, s_tpk, (uint32_t)own_ts, ring, base, t0 * N, count, row_sa);
    }
    __syncwarp();
    {
      // Four symbols a lane: rank = the stored half >> 3; 0 past the count
      // or the alphabet.
      const uint2 r = reinterpret_cast<const uint2*>(rowbuf)[lane];
      const int i0 = t0 * N + 4 * lane;
      auto sym = [&](uint32_t half, int i) -> uint32_t {
        const uint32_t rank = half >> 3;
        return (i < count && rank < (uint32_t)own_asz) ? (s_alpha[rank] & 0xFFFFu) : 0u;
      };
      uint2 v;
      v.x = sym(r.x & 0xFFFFu, i0) | (sym(r.x >> 16, i0 + 1) << 16);
      v.y = sym(r.y & 0xFFFFu, i0 + 2) | (sym(r.y >> 16, i0 + 3) << 16);
      *reinterpret_cast<uint2*>(o + i0) = v;
    }
    __syncwarp();
  }
}

// wdesc[block * warps + warp] = (group, stream, the stream's shared-memory
// offset in words, 0); group < 0 marks a warp with no stream.
__global__ void __launch_bounds__(kMaxWarps * 32)
tans_groups_kernel(const GroupDesc* __restrict__ groups, const int4* __restrict__ wdesc,
                   Outs outs) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int4 d = wdesc[blockIdx.x * (blockDim.x >> 5) + warp];
  if (d.x < 0) return;
  const GroupDesc g = groups[d.x];
  // Selects, not an index: a kernel argument indexed at run time would be
  // copied to local memory.
  uint16_t* out = outs.p[0];
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i)
    if (d.x == i) out = outs.p[i];
  uint32_t* pool = reinterpret_cast<uint32_t*>(smem) + d.z;
  switch (g.n_states) {
    case 2: decode_stream<2>(g, out, d.y, pool, lane); break;
    case 4: decode_stream<4>(g, out, d.y, pool, lane); break;
    default: decode_stream<8>(g, out, d.y, pool, lane); break;
  }
}

cudaError_t allow_shared(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tans_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

extern "C" {

// One launch over every group's streams.  groups and wdesc are device
// arrays (above); outs is a host array of n_groups device pointers.
// Returns cudaErrorInvalidValue for sizes the kernel does not take, else
// the launch's error (cudaGetLastError()).
int mic_tans_decode_groups(const void* groups, const void* wdesc, const void* const* outs,
                           int n_groups, int n_blocks, int warps, int smem_bytes, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || warps < 1 || warps > kMaxWarps || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  Outs o = {};
  for (int i = 0; i < n_groups; ++i) o.p[i] = (uint16_t*)outs[i];
  const cudaError_t e = allow_shared(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  tans_groups_kernel<<<n_blocks, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
      (const GroupDesc*)groups, (const int4*)wdesc, o);
  return (int)cudaGetLastError();
}

// Blocks of `warps` warps and smem_bytes of shared memory that one SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus
// the CUDA error.
int mic_tans_occupancy(int warps, int smem_bytes) {
  int n = 0;
  cudaError_t e = allow_shared(smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tans_groups_kernel, warps * 32,
                                                      smem_bytes);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
