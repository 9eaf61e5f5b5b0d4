// Wide-lane rANS encode of the MICT format (FF 57 and FF 41) for Hopper.
//
// rans_enc_kernel<ALIAS> replaces mic_tpu/tpu/pallas_enc.py:_kernel_enc
// in both its forms: wrapper rans_encode_pallas (ALIAS = false, FF 57)
// and rans_encode_pallas_alias (ALIAS = true, FF 41, the written slot
// mapped through a 256-entry run table).
//
// Each lane of each strip is an independent rANS chain walked from its
// last symbol back to its first.  Unlike the decoders there is no lane
// prefix sum: every renorm word goes out dense at its own (step, lane)
// slot with a flag beside it, and the host compacts words[flags] in
// (step asc, lane asc) order, which is the decoder's word order.  So one
// thread is one (strip, lane) and one block of 128 threads is one strip,
// with no barrier inside the step loop.  The strip's per-rank tables
// (te1/te2: its own alphabet's entries, at most 2 x 4096 x 4 B = 32 KB)
// and, for FF 41, its run tables (2 x 256 x 4 B) are staged in shared
// memory; rank loads and word/flag stores are coalesced across the 128
// lanes of a step.
//
// Per step (pallas_enc.py:139-196): active = t*128 + lane < count;
// need = x >= f << (32 - tl) on active lanes; a renorming lane emits
// x & 0xFFFF and shifts x right by 16; then q = x / f by the magic
// multiply (__umulhi gives the same high word as the Pallas kernel's four
// 16-bit partial products) with the add/shift fix-up (f == 1: q = x),
// rem = x - q*f, and x = (q << tl) + cum + rem (FF 57) or
// (q << tl) + base[r] + (cum + rem - start[r]) with r the last run whose
// start <= cum + rem (FF 41).  Inactive lanes keep their state.
//
// The FF 41 slot is one shared-memory read: the block's prologue builds
// map[s] = base[r(s)] + (s - start[r(s)]) as u16 for every slot s below
// 2^min(tl, 12) (tl of the strip's lane 0), a run at a time: each thread
// takes two runs and writes run r's slots [start[r], start[r+1]) (run 0
// from slot 0).  On sorted starts that is the search's run, equal starts
// and slots below start[0] included.  Guards keep the kernel equal to the
// search on any operands, with no branch in the step: a lane whose cum +
// rem is past the map marks its strip, and a marked strip, or one whose
// starts are not sorted or whose map value does not fit 16 bits, walks
// its steps (again) with the 9-round binary search on the staged run
// tables, rewriting every output.  Neither happens on a valid stream.
//
// The chain of a step is the renorm test, __umulhi, the fix-up, q*f and
// the shift-add (and the map read).  What does not depend on the state
// is loaded ahead, in registers: the rank of step t - 2 and the table
// entries of step t - 1 during step t; the loop takes two steps an
// iteration.
//
// Cost: each symbol moves 6 bytes (a u16 rank in, a u16 word and a u16
// flag out): 0.186 / 0.182 ms at 3.35 TB/s for 1536 strips x 512 steps
// (chip_smoke.py phase 2, FF 57 / FF 41).  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/enc_design_points.py): FF 57 0.283 ms, 552
// ns a step of the launch (0.308-0.313 before: the rank of step t was
// loaded in step t), FF 41 0.294-0.298 ms, 574-582 ns (0.725-0.750
// before, 1416-1465 ns: the search's 11 dependent, bank-conflicted shared
// reads a step).  FF 57 fits 16 blocks an SM, FF 41 (40 registers) 12:
// either way all 1536 blocks are resident at once, 11-12 an SM.  Both run
// at about 1.5x and 1.6x the bytes' bound, held by the SM's issue, not
// the bytes: a step takes 53.5 instructions and 2 shared reads (FF 57),
// 58 and 3 (FF 41; cuobjdump -sass of the step loop, two steps an
// iteration), a warp each, ~46 warps an SM.
//
// Forms for scripts/enc_design_points.py (-D flags, a library each):
// MIC_ENC_SLOT 0 the 9-round search on every step, 1 the map filled a run
// at a time (a thread a run; the default), 2 a slot at a time (one search
// each), 3 an Eytzinger (breadth-first) layout of the starts, searched;
// MIC_ENC_PREFETCH 0 (loads in the step), 1 or 2 (the default) steps of
// rank prefetch; MIC_ENC_TEAM 128 (a block of 128 threads a strip, the
// default) or 32 (a warp a strip, four lanes a thread); MIC_ENC_UNROLL 2
// (the default) or 1 steps an iteration.
//
// Guards, shared with the plain PyTorch versions in
// mic_tpu_torch/tpu/rans_encode.py (valid operands never reach them): a
// rank at or beyond the strip's table width (its own width, or aw) reads
// zero entries (freq 1, magic 0, so no division and no read past shared
// memory), and a shift by >= 32 gives 0 (jax.lax.shift_left's rule; a C++
// shift by >= 32 is undefined).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  The C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef MIC_ENC_SLOT
#define MIC_ENC_SLOT 1
#endif
#ifndef MIC_ENC_PREFETCH
#define MIC_ENC_PREFETCH 2
#endif
#ifndef MIC_ENC_TEAM
#define MIC_ENC_TEAM 128
#endif
#ifndef MIC_ENC_UNROLL
#define MIC_ENC_UNROLL 2
#endif

namespace {

constexpr int kLanes = 128;
constexpr int kRuns = 256;
constexpr int kTeam = MIC_ENC_TEAM;       // threads a strip (a block)
constexpr int kChains = kLanes / kTeam;   // lanes a thread
constexpr int kMapSlots = 1 << 12;        // ALIAS_TABLE_LOG
constexpr bool kMap = MIC_ENC_SLOT == 1 || MIC_ENC_SLOT == 2;
constexpr bool kEyt = MIC_ENC_SLOT == 3;
constexpr int kEytNodes = 512;            // 511 nodes, index 0 unused
constexpr int kDepth = MIC_ENC_PREFETCH;
constexpr int kUnroll = MIC_ENC_UNROLL;
static_assert(kLanes % kTeam == 0 && kTeam % 32 == 0, "a team is whole warps");
static_assert(MIC_ENC_SLOT >= 0 && MIC_ENC_SLOT <= 3, "MIC_ENC_SLOT is 0-3");
static_assert(kDepth >= 0 && kDepth <= 2, "MIC_ENC_PREFETCH is 0-2");

// Dynamic shared memory of one FF 41 block beyond its te1/te2 tables.
constexpr size_t kAliasExtra = kMap ? kMapSlots * sizeof(uint16_t)
                             : kEyt ? kEytNodes * sizeof(uint32_t) : 0;

__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  return s < 32u ? (x << s) : 0u;
}

// The run of s_idx by the Pallas kernel's rule (pallas_enc.py:175-190):
// (the count of starts <= s_idx by a 9-round binary search over the 256
// entries, pad 0xFFFFFFFF) - 1, at least 0.
__device__ __forceinline__ int search_run(const uint32_t* s_start, uint32_t s_idx) {
  int n_le = 0;
#pragma unroll
  for (int st = kRuns; st; st >>= 1) {
    const int cand = n_le + st;
    if (cand <= kRuns && s_start[min(cand - 1, kRuns - 1)] <= s_idx) n_le = cand;
  }
  return max(n_le - 1, 0);
}

// The slot: base[r] + (s_idx - start[r]) = delta[r] + s_idx mod 2^32.
__device__ __forceinline__ uint32_t search_slot(const uint32_t* s_start,
                                                const uint32_t* s_delta, uint32_t s_idx) {
  return s_delta[search_run(s_start, s_idx)] + s_idx;
}

template <bool ALIAS>
__global__ void __launch_bounds__(kTeam)
rans_enc_kernel(const uint16_t* __restrict__ ranks, const uint32_t* __restrict__ te1,
                const uint32_t* __restrict__ te2, int aw, const uint32_t* __restrict__ widths,
                const uint32_t* __restrict__ ar1, const uint32_t* __restrict__ ar2,
                const uint32_t* __restrict__ count, const uint32_t* __restrict__ tls,
                uint16_t* __restrict__ out_w, uint16_t* __restrict__ out_f,
                uint32_t* __restrict__ out_x, int steps) {
  extern __shared__ uint32_t smem[];
  // FF 41's run starts and base[r] - start[r] (u32)
  __shared__ uint32_t s_start[ALIAS ? kRuns : 1], s_delta[ALIAS ? kRuns : 1];
  const int s = blockIdx.x, tid = threadIdx.x;
  // The strip's own table width: entries past it read as 0.
  const uint32_t width = widths ? min(widths[s], (uint32_t)aw) : (uint32_t)aw;
  for (uint32_t i = tid; i < width; i += kTeam) {
    smem[i] = te1[(size_t)s * aw + i];
    smem[aw + i] = te2[(size_t)s * aw + i];
  }
  uint32_t msize = 0;  // FF 41: a lane whose cum + rem is below msize reads the map
  if constexpr (ALIAS) {
    bool bad = false;  // unsorted starts, or a map value past 16 bits
    for (int i = tid; i < kRuns; i += kTeam) {
      const uint32_t st = ar1[(size_t)s * kRuns + i];
      s_start[i] = st;
      s_delta[i] = ar2[(size_t)s * kRuns + i] - st;
    }
    __syncthreads();
    if constexpr (kMap) {
      uint16_t* s_map = reinterpret_cast<uint16_t*>(smem + 2 * aw);
      msize = 1u << min(tls[(size_t)s * kLanes], 12u);
      if constexpr (MIC_ENC_SLOT == 1) {
        // A thread a run: run r writes [start[r], start[r+1]), run 0 from
        // slot 0 (on sorted starts, one writer a slot).
        for (int r = tid; r < kRuns; r += kTeam) {
          const uint32_t st = s_start[r];
          const uint32_t nx = r + 1 < kRuns ? s_start[r + 1] : 0xFFFFFFFFu;
          bad |= nx < st;
          const uint32_t hi = min(nx, msize), d = s_delta[r];
          for (uint32_t i = r ? st : 0u; i < hi; ++i) {
            const uint32_t v = d + i;
            bad |= v > 0xFFFFu;
            s_map[i] = (uint16_t)v;
          }
        }
      } else {
        // Each slot by the search itself: right on any starts.
        for (uint32_t i = tid; i < msize; i += kTeam) {
          const uint32_t v = search_slot(s_start, s_delta, i);
          bad |= v > 0xFFFFu;
          s_map[i] = (uint16_t)v;
        }
      }
    } else if constexpr (kEyt) {
      // Node i (depth d, position p) holds the in-order entry
      // (2p + 1) * 2^(8 - d) - 1; past the 256 starts, 0xFFFFFFFF.
      uint32_t* s_eyt = smem + 2 * aw;
      for (int r = tid; r + 1 < kRuns; r += kTeam) bad |= s_start[r + 1] < s_start[r];
      for (int i = tid + 1; i < kEytNodes; i += kTeam) {
        const int d = 31 - __clz(i), p = i - (1 << d);
        const int in = ((2 * p + 1) << (8 - d)) - 1;
        s_eyt[i] = in < kRuns ? s_start[in] : 0xFFFFFFFFu;
      }
      msize = kMapSlots;
    }
    if (__syncthreads_or(bad)) msize = 0;
  } else {
    __syncthreads();
  }

  const uint16_t* s_map = reinterpret_cast<const uint16_t*>(smem + 2 * aw);
  const uint32_t* s_eyt = smem + 2 * aw;
  // Rank rk's te1 and te2 entries.
  auto entries = [&](uint32_t rk, uint32_t& e1, uint32_t& m) {
    if (rk < width) {
      e1 = smem[rk];
      m = smem[aw + rk];
    } else {
      e1 = m = 0u;
    }
  };

  const size_t row = (size_t)s * steps * kLanes + tid;  // lane tid of step 0
  uint32_t tl[kChains];
  int cnt[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    const size_t li = (size_t)s * kLanes + tid + k * kTeam;
    cnt[k] = (int)count[li];  // signed compare, as the Pallas kernel's int32 cast
    tl[k] = tls[li];
  }
  auto rank_at = [&](int t, int k) -> uint32_t {
    return t >= 0 ? ranks[row + (size_t)t * kLanes + k * kTeam] : 0u;
  };
  // One walk over the strip's steps, last to first, writing every output.
  // FF 41 with FAST reads the slot from the map (or the Eytzinger tree)
  // and returns whether a lane's cum + rem left it (the slot read is then
  // wrong, and the walk must be made again with the search).
  auto walk = [&](auto fast_tag) -> bool {
    constexpr bool FAST = decltype(fast_tag)::value;
    uint32_t x[kChains];
    bool oob = false;
#pragma unroll
    for (int k = 0; k < kChains; ++k) x[k] = 1u << 16;
#if MIC_ENC_PREFETCH > 0
    // ring[d][k]: the rank of step t - 1 - d; e1n / mn: step t's entries.
    uint32_t ring[kDepth][kChains], e1n[kChains], mn[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      entries(rank_at(steps - 1, k), e1n[k], mn[k]);
#pragma unroll
      for (int d = 0; d < kDepth; ++d) ring[d][k] = rank_at(steps - 2 - d, k);
    }
#endif
#pragma unroll kUnroll
    for (int t = steps - 1; t >= 0; --t) {
      const size_t o = row + (size_t)t * kLanes;
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        const int lane = tid + k * kTeam;
#if MIC_ENC_PREFETCH > 0
        const uint32_t e1 = e1n[k], m = mn[k];
        entries(ring[0][k], e1n[k], mn[k]);
#pragma unroll
        for (int d = 0; d + 1 < kDepth; ++d) ring[d][k] = ring[d + 1][k];
        ring[kDepth - 1][k] = rank_at(t - 1 - kDepth, k);
#else
        uint32_t e1, m;
        entries(ranks[o + k * kTeam], e1, m);
#endif
        const bool active = t * kLanes + lane < cnt[k];
        const uint32_t f = (e1 >> 18) + 1u;
        const uint32_t c = (e1 >> 4) & 0xFFFu;
        const uint32_t sh = e1 & 0xFu;
        const bool need = active && x[k] >= shl(f, 32u - tl[k]);
        out_w[o + k * kTeam] = need ? (uint16_t)(x[k] & 0xFFFFu) : (uint16_t)0u;
        out_f[o + k * kTeam] = (uint16_t)need;
        const uint32_t x1 = need ? (x[k] >> 16) : x[k];
        const uint32_t th = __umulhi(x1, m);
        uint32_t q = ((e1 >> 17) & 1u) ? ((th + ((x1 - th) >> 1)) >> sh) : (th >> sh);
        if ((e1 >> 16) & 1u) q = x1;
        const uint32_t rem = x1 - q * f;
        uint32_t x2;
        if constexpr (ALIAS) {
          const uint32_t s_idx = rem + c;
          uint32_t slot;
          if constexpr (FAST && kMap) {
            oob |= s_idx >= msize;
            slot = s_map[s_idx & (msize - 1)];
          } else if constexpr (FAST && kEyt) {
            oob |= s_idx >= msize;
            uint32_t n = 1;
#pragma unroll
            for (int d = 0; d < 9; ++d) n = 2 * n + (s_eyt[n] <= s_idx ? 1u : 0u);
            slot = s_delta[max((int)n - kEytNodes - 1, 0)] + s_idx;
          } else {
            slot = search_slot(s_start, s_delta, s_idx);
          }
          x2 = shl(q, tl[k]) + slot;
        } else {
          x2 = shl(q, tl[k]) + rem + c;
        }
        x[k] = active ? x2 : x1;
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) out_x[(size_t)s * kLanes + tid + k * kTeam] = x[k];
    return oob;
  };
  if constexpr (ALIAS && (kMap || kEyt)) {
    // The map's walk; where the map is unusable, or a lane left it, the
    // search's walk writes every output again.
    bool redo = msize == 0;
    if (!redo) redo = __syncthreads_or(walk(std::true_type{}));
    if (redo) walk(std::false_type{});
  } else {
    walk(std::false_type{});
  }
}

size_t smem_bytes(int aw, int alias) {
  return (size_t)2 * aw * sizeof(uint32_t) + (alias ? kAliasExtra : 0);
}

template <bool ALIAS>
const void* kernel_of() {
  return (const void*)rans_enc_kernel<ALIAS>;
}

}  // namespace

extern "C" {

// alias != 0 selects the FF 41 form (ar1/ar2 are then read); widths (u32
// [n_strips], each strip's own table width) may be null: every strip then
// stages aw entries.  Returns cudaErrorInvalidValue for a table width the
// kernel does not take, else cudaGetLastError() after the launch.
int mic_rans_encode(const void* ranks, const void* te1, const void* te2, int aw,
                    const void* widths, const void* ar1, const void* ar2,
                    const void* count, const void* tls, void* out_w, void* out_f,
                    void* out_x, int n_strips, int steps, int alias, void* stream) {
  if (aw <= 0 || aw > 4096 || n_strips <= 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(aw, alias);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        alias ? kernel_of<true>() : kernel_of<false>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  auto* rk = (const uint16_t*)ranks;
  auto* t1 = (const uint32_t*)te1;
  auto* t2 = (const uint32_t*)te2;
  auto* wd = (const uint32_t*)widths;
  auto* a1 = (const uint32_t*)ar1;
  auto* a2 = (const uint32_t*)ar2;
  auto* cn = (const uint32_t*)count;
  auto* tl = (const uint32_t*)tls;
  auto* w = (uint16_t*)out_w;
  auto* f = (uint16_t*)out_f;
  auto* x = (uint32_t*)out_x;
  if (alias)
    rans_enc_kernel<true><<<n_strips, kTeam, smem, st>>>(rk, t1, t2, aw, wd, a1, a2, cn, tl,
                                                         w, f, x, steps);
  else
    rans_enc_kernel<false><<<n_strips, kTeam, smem, st>>>(rk, t1, t2, aw, wd, a1, a2, cn, tl,
                                                          w, f, x, steps);
  return (int)cudaGetLastError();
}

// The launch shape of a table width: out[0] shared-memory bytes a block
// (dynamic and static), out[1] blocks resident an SM, out[2] threads a
// block.  Returns a CUDA error code.
int mic_rans_encode_shape(int aw, int alias, int* out) {
  const size_t smem = smem_bytes(aw, alias);
  const void* fn = alias ? kernel_of<true>() : kernel_of<false>();
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kTeam, smem);
  out[0] = (int)(smem + attr.sharedSizeBytes);
  out[1] = blocks;
  out[2] = kTeam;
  return (int)e;
}

}  // extern "C"
