// micfse.cpp — native host tier for mic_tpu_torch (a copy of mic_tpu's).
//
// Fast C++ implementations of the host-format hot loops, exposed via a
// C ABI for ctypes: FSE/tANS 1/2/4/8-state encode+decode, 8-state rANS
// decode, 16-bit RLE, and the fused Delta+RLE predictor pipelines
// (avg/grad/med/zz).  This tier mirrors the role of the reference's C
// pipeline (ojph/mic_compress_c.c, mic_decompress_c.c): same stream
// formats as the Python host tier (which defines them), restructured as
// a two-pass decoder — entropy decode into a symbol buffer, then RLE
// expansion, then predictor inversion.
//
// Everything here is a fresh implementation written against the format
// contract documented in mic_tpu_torch/ops/*.py.  Only this header
// comment differs from mic_tpu/native/micfse.cpp.
//
// Build: mic_tpu_torch._build.host_library() compiles this file with the
// host compiler ($CXX, else c++ or g++) at the first native call, into
// build/libmicfse-<hash>.so at the repository root, and loads it with
// ctypes (mic_tpu_torch.native).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#include <memory>

#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace {

// ───────────────────────── bit I/O ─────────────────────────
// FSE convention: LSB-first stream, written forward, read in reverse.
// The last byte's highest set bit is the end mark.

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  unsigned nbits = 0;
  size_t pos = 0;  // bytes committed into out

  // Size the buffer once so the hot path is a plain 8-byte store; the
  // stream can never exceed ~(maxTableLog+1)/8 bytes per value plus the
  // 8-byte spill slack.
  inline void reserve_values(size_t n_values) {
    out.resize(n_values * 3 + 64);
  }
  inline void add(uint32_t v, unsigned n) {
    acc |= (uint64_t)(v & ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1))) << nbits;
    nbits += n;
    if (nbits >= 32) {
      std::memcpy(out.data() + pos, &acc, 8);  // low 4 valid, 4 slack
      pos += 4;
      acc >>= 32;
      nbits -= 32;
    }
  }
  // Branchless variant for counted hot loops: unconditional 8-byte store
  // + byte-granular advance keeps nbits < 8 with no flush branch to
  // mispredict.  Bit-identical stream (same LSB-first bit positions).
  inline void add_fast(uint32_t v, unsigned n) {
#if defined(__BMI2__)
    acc |= (uint64_t)_bzhi_u32(v, n) << nbits;
#else
    acc |= (uint64_t)(v & ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1))) << nbits;
#endif
    nbits += n;
    std::memcpy(out.data() + pos, &acc, 8);
    unsigned adv = nbits >> 3;
    pos += adv;
    acc >>= adv * 8;
    nbits &= 7;
  }
  inline void close() {
    add(1, 1);  // end mark
    while (nbits) {
      out[pos++] = (uint8_t)acc;
      acc >>= 8;
      nbits = nbits >= 8 ? nbits - 8 : 0;
    }
    out.resize(pos);
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t pos;        // bits remaining
  uint64_t win = 0;   // cached bits [8*wbase, 8*wbase+64)
  int64_t wbase = 1 << 30;  // byte base of the window (force initial refill)

  bool init(const uint8_t* d, size_t len) {
    if (len < 1 || d[len - 1] == 0) return false;
    data = d;
    unsigned hb = 31 - __builtin_clz((uint32_t)d[len - 1]);
    pos = (int64_t)8 * (int64_t)(len - 1) + hb;
    wbase = 1 << 30;
    return true;
  }
  // Read the top n unread bits (the most recently written).  Callers copy
  // the stream into a buffer padded by >= 8 bytes on both sides, so the
  // 8-byte window loads never overrun even for pos < 0 over-reads.
  inline uint32_t get(unsigned n) {
    if (n == 0) return 0;
    pos -= n;
    // Exhausted streams park in the 8-byte zero pad in front of the
    // buffer: reads return zero bits and never refill below the pad.
    if (pos < -32) pos = -32;
    if (pos < wbase * 8) {
      // Reposition the window so ~32 bits can be consumed before the
      // next refill: window bottom 4 bytes below the current bit.
      wbase = (pos >> 3) - 4;
      if (wbase < -8) wbase = -8;
      std::memcpy(&win, data + wbase, 8);
    }
    return (uint32_t)((win >> (pos - wbase * 8)) & (((uint64_t)1 << n) - 1));
  }
};
// Over-read semantics (pos < 0): the padded zero bytes in front of the
// buffer make the returned low bits zero, matching the host tier.

// ───────────────────────── FSE core ─────────────────────────

constexpr int kMaxTableLog = 16;
constexpr int kMinTableLog = 5;
constexpr int kMaxSymbol = 65535;

static inline int high_bit(uint32_t v) { return 31 - __builtin_clz(v); }

struct Norm {
  std::vector<int32_t> norm;  // -1 = low prob
  int symbol_len = 0;
  int table_log = 0;
};

static int optimal_table_log(int hint, int64_t src_len, int symbol_len) {
  int tl = hint;
  int min_bits_src = high_bit((uint32_t)(src_len - 1)) + 1;
  int min_bits_sym = high_bit((uint32_t)(symbol_len - 1)) + 2;
  int min_bits = min_bits_src < min_bits_sym ? min_bits_src : min_bits_sym;
  int max_bits_src = high_bit((uint32_t)(src_len - 1)) - 2;
  if (max_bits_src < tl) tl = max_bits_src;
  if (min_bits > tl) tl = min_bits;
  int64_t density = src_len / symbol_len;
  if (symbol_len > 512 && density > 16 && tl < 13) tl = 13;
  else if (density > 64 && symbol_len > 256 && tl < 12) tl = 12;
  else if (density > 32 && symbol_len > 128 && tl < 12) tl = 12;
  if (max_bits_src < tl) tl = max_bits_src;
  if (tl < kMinTableLog) tl = kMinTableLog;
  if (tl > kMaxTableLog) tl = kMaxTableLog;
  return tl;
}

static const uint32_t kRtb[8] = {0, 473195, 504333, 520860, 550000, 700000, 750000, 830000};

static bool normalize2(const uint32_t* counts, int64_t total_in, Norm& nm) {
  const int tl = nm.table_log;
  const int sl = nm.symbol_len;
  int64_t total = total_in;
  int64_t distributed = 0;
  int64_t low_threshold = total >> tl;
  int64_t low_one = (total * 3) >> (tl + 1);
  const int32_t kTBD = -2;
  for (int i = 0; i < sl; i++) {
    uint32_t c = counts[i];
    if (c == 0) { nm.norm[i] = 0; continue; }
    if ((int64_t)c <= low_threshold) { nm.norm[i] = -1; distributed++; total -= c; continue; }
    if ((int64_t)c <= low_one) { nm.norm[i] = 1; distributed++; total -= c; continue; }
    nm.norm[i] = kTBD;
  }
  int64_t to_distribute = ((int64_t)1 << tl) - distributed;
  if (to_distribute > 0 && total / to_distribute > low_one) {
    low_one = (total * 3) / (to_distribute * 2);
    for (int i = 0; i < sl; i++) {
      if (nm.norm[i] == kTBD && (int64_t)counts[i] <= low_one) {
        nm.norm[i] = 1; distributed++; total -= counts[i];
      }
    }
    to_distribute = ((int64_t)1 << tl) - distributed;
  }
  if (distributed == sl + 1) {
    int max_v = 0; uint32_t max_c = 0;
    for (int i = 0; i < sl; i++) if (counts[i] > max_c) { max_c = counts[i]; max_v = i; }
    nm.norm[max_v] += (int32_t)to_distribute;
    return true;
  }
  if (total == 0) {
    for (int i = 0; to_distribute > 0; i = (i + 1) % sl)
      if (nm.norm[i] > 0) { to_distribute--; nm.norm[i]++; }
    return true;
  }
  int v_step_log = 62 - tl;
  uint64_t mid = ((uint64_t)1 << (v_step_log - 1)) - 1;
  uint64_t r_step = ((((uint64_t)1 << v_step_log) * (uint64_t)to_distribute) + mid) / (uint64_t)total;
  uint64_t tmp_total = mid;
  for (int i = 0; i < sl; i++) {
    if (nm.norm[i] == kTBD) {
      uint64_t end = tmp_total + (uint64_t)counts[i] * r_step;
      uint32_t w = (uint32_t)((end >> v_step_log) - (tmp_total >> v_step_log));
      if (w < 1) return false;
      nm.norm[i] = (int32_t)w;
      tmp_total = end;
    }
  }
  return true;
}

// Reference validateNorm (fsecompressu16.go:58,670): normalize2's
// fixed-point redistribution wraps on pathological histograms (many
// lowprob symbols, tiny tableLog — e.g. random noise after escaping);
// the sum check rejects those so the caller falls down the state chain
// instead of feeding a non-summing table to spread() (which would spin).
static bool validate_norm(const Norm& nm) {
  int64_t total = 0;
  for (int i = 0; i < nm.symbol_len; i++) {
    int32_t v = nm.norm[i];
    total += v >= 0 ? v : -v;  // -1 lowprob counts as one slot
  }
  return total == ((int64_t)1 << nm.table_log);
}

static bool normalize(const uint32_t* counts, int64_t total, Norm& nm) {
  const int tl = nm.table_log;
  const int sl = nm.symbol_len;
  nm.norm.assign(sl, 0);
  int scale = 62 - tl;
  uint64_t step = ((uint64_t)1 << 62) / (uint64_t)total;
  uint64_t v_step = (uint64_t)1 << (scale - 20);
  int64_t still = (int64_t)1 << tl;
  int largest = 0;
  int64_t largest_p = 0;
  int64_t low_threshold = total >> tl;
  for (int i = 0; i < sl; i++) {
    uint32_t c = counts[i];
    if (c == 0) continue;
    if ((int64_t)c <= low_threshold) { nm.norm[i] = -1; still--; continue; }
    uint64_t prod = (uint64_t)c * step;
    int64_t proba = (int64_t)(prod >> scale);
    if (proba < 8) {
      uint64_t rest = v_step * kRtb[proba];
      uint64_t v = prod - ((uint64_t)proba << scale);
      if (v > rest) proba++;
    }
    if (proba > largest_p) { largest_p = proba; largest = i; }
    nm.norm[i] = (int32_t)proba;
    still -= proba;
  }
  if (-still >= (nm.norm[largest] >> 1)) return normalize2(counts, total, nm);
  nm.norm[largest] += (int32_t)still;
  return true;
}

// Normalized-count header: variable-width with zero-run coding.
static bool write_count(const Norm& nm, std::vector<uint8_t>& out) {
  int tl = nm.table_log;
  int table_size = 1 << tl;
  int64_t bit_stream = tl - kMinTableLog;
  int bit_count = 4;
  int remaining = table_size + 1;
  int threshold = table_size;
  int nb_bits = tl + 1;
  bool previous0 = false;
  int charnum = 0;

  while (remaining > 1) {
    if (previous0) {
      int start = charnum;
      while (nm.norm[charnum] == 0) charnum++;
      while (charnum >= start + 24) {
        start += 24;
        bit_stream += (int64_t)0xFFFF << bit_count;
        out.push_back((uint8_t)bit_stream);
        out.push_back((uint8_t)(bit_stream >> 8));
        bit_stream >>= 16;
      }
      while (charnum >= start + 3) { start += 3; bit_stream += (int64_t)3 << bit_count; bit_count += 2; }
      bit_stream += (int64_t)(charnum - start) << bit_count;
      bit_count += 2;
      if (bit_count > 16) {
        out.push_back((uint8_t)bit_stream);
        out.push_back((uint8_t)(bit_stream >> 8));
        bit_stream >>= 16;
        bit_count -= 16;
      }
    }
    int count = nm.norm[charnum++];
    int maxv = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += maxv;
    bit_stream += (int64_t)count << bit_count;
    bit_count += nb_bits;
    if (count < maxv) bit_count--;
    previous0 = count == 1;
    if (remaining < 1) return false;
    while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    if (bit_count > 16) {
      out.push_back((uint8_t)bit_stream);
      out.push_back((uint8_t)(bit_stream >> 8));
      bit_stream >>= 16;
      bit_count -= 16;
    }
  }
  out.push_back((uint8_t)bit_stream);
  out.push_back((uint8_t)(bit_stream >> 8));
  int extra = (bit_count + 7) / 8;
  out.resize(out.size() - 2 + extra);
  return charnum <= nm.symbol_len;
}

static bool read_ncount(const uint8_t* data, size_t len, Norm& nm, size_t* consumed) {
  if (len < 4) return false;
  auto u32 = [&](size_t off) -> uint32_t {
    uint32_t v = 0;
    size_t n = len - off < 4 ? len - off : 4;
    std::memcpy(&v, data + off, n);
    return v;
  };
  int64_t iend = (int64_t)len;
  int64_t off = 0;
  uint32_t bit_stream = u32(0);
  int nb_bits = (int)(bit_stream & 0xF) + kMinTableLog;
  if (nb_bits > 17) return false;
  bit_stream >>= 4;
  int bit_count = 4;
  nm.table_log = nb_bits;
  int remaining = (1 << nb_bits) + 1;
  int threshold = 1 << nb_bits;
  int64_t got_total = 0;
  nb_bits++;

  // Every entry below the final charnum is written during the parse
  // (zero runs included), so a capacity-preserving resize suffices — the
  // 256KB zero-fill of assign() costs more than the whole header parse.
  if (nm.norm.size() < (size_t)kMaxSymbol + 1) nm.norm.resize(kMaxSymbol + 1);
  int charnum = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      int n0 = charnum;
      while ((bit_stream & 0xFFFF) == 0xFFFF) {
        n0 += 24;
        if (off < iend - 5) { off += 2; bit_stream = u32(off) >> bit_count; }
        else { bit_stream >>= 16; bit_count += 16; }
      }
      while ((bit_stream & 3) == 3) { n0 += 3; bit_stream >>= 2; bit_count += 2; }
      n0 += bit_stream & 3;
      bit_count += 2;
      if (n0 > kMaxSymbol) return false;
      while (charnum < n0) nm.norm[charnum++ & 0xFFFF] = 0;
      if (off <= iend - 7 || off + (bit_count >> 3) <= iend - 4) {
        off += bit_count >> 3;
        bit_count &= 7;
        bit_stream = u32(off) >> bit_count;
      } else {
        bit_stream >>= 2;
      }
    }
    int maxv = (2 * threshold - 1) - remaining;
    int count;
    if ((int)(bit_stream & (threshold - 1)) < maxv) {
      count = (int)(bit_stream & (threshold - 1));
      bit_count += nb_bits - 1;
    } else {
      count = (int)(bit_stream & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      bit_count += nb_bits;
    }
    count--;
    if (count < 0) { remaining += count; got_total -= count; }
    else { remaining -= count; got_total += count; }
    nm.norm[charnum++ & 0xFFFF] = count;
    previous0 = count == 0;
    while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    if (off <= iend - 7 || off + (bit_count >> 3) <= iend - 4) {
      off += bit_count >> 3;
      bit_count &= 7;
    } else {
      bit_count -= 8 * (int)(iend - 4 - off);
      off = iend - 4;
    }
    bit_stream = u32(off) >> (bit_count & 31);
  }
  nm.symbol_len = charnum;
  if (charnum <= 1 || charnum > kMaxSymbol + 1) return false;
  if (remaining != 1 || bit_count > 32) return false;
  if (got_total != (int64_t)1 << nm.table_log) return false;
  off += (bit_count + 7) >> 3;
  *consumed = (size_t)off;
  return true;
}

static uint32_t table_step(uint32_t ts) { return (ts >> 1) + (ts >> 3) + 3; }

// Packed decode table: one u64 per slot, new_state<<32 | symbol<<16 |
// nb_bits — the hot loop touches one cache line per symbol.
using DTable = std::vector<uint64_t>;
static inline uint64_t dt_pack(uint32_t ns, uint16_t sym, uint8_t nb) {
  return ((uint64_t)ns << 32) | ((uint64_t)sym << 16) | nb;
}

// Per-thread scratch: decode buffers are reused across calls so the hot
// path never hits malloc/mmap (fresh multi-100KB allocations cost ~0.7ms
// per frame in page faults on this class of VM — measured).
struct DecScratch {
  std::vector<uint8_t> buf;      // padded bitstream copy
  std::vector<uint16_t> spread_tbl;
  DTable dt;
  std::vector<uint16_t> rle;     // entropy output (RLE/SoA symbols)
  std::vector<uint16_t> tokens;  // expanded tokens
  std::vector<uint16_t> enc_tokens;  // encoder residual tokens
  Norm nm;                       // parsed normalized counts
};
static DecScratch& scratch() {
  thread_local DecScratch s;
  return s;
}

static bool spread(const Norm& nm, std::vector<uint16_t>& tbl) {
  uint32_t ts = 1u << nm.table_log;
  tbl.assign(ts, 0);
  int32_t high = (int32_t)ts - 1;
  for (int i = 0; i < nm.symbol_len; i++)
    if (nm.norm[i] == -1) tbl[high--] = (uint16_t)i;
  uint32_t step = table_step(ts), maskv = ts - 1, position = 0;
  for (int s = 0; s < nm.symbol_len; s++) {
    for (int32_t k = 0; k < nm.norm[s]; k++) {
      tbl[position] = (uint16_t)s;
      position = (position + step) & maskv;
      while ((int32_t)position > high) position = (position + step) & maskv;
    }
  }
  return position == 0;
}

static bool build_dtable(const Norm& nm, DTable& dt,
                         std::vector<uint16_t>& tbl) {
  uint32_t ts = 1u << nm.table_log;
  if (!spread(nm, tbl)) return false;
  std::vector<uint32_t> nxt(nm.symbol_len);
  for (int i = 0; i < nm.symbol_len; i++)
    nxt[i] = nm.norm[i] == -1 ? 1 : (nm.norm[i] > 0 ? (uint32_t)nm.norm[i] : 0);
  dt.resize(ts);
  for (uint32_t u = 0; u < ts; u++) {
    uint16_t s = tbl[u];
    uint32_t x = nxt[s]++;
    int nb = nm.table_log - high_bit(x);
    uint32_t ns = (x << nb) - ts;
    if (ns >= ts) return false;
    dt[u] = dt_pack(ns, s, (uint8_t)nb);
  }
  return true;
}

struct CTable {
  std::vector<uint32_t> state_table;
  // Fused per-symbol transform: delta_find<<32 | delta_nb — the encode
  // step touches ONE cache line per symbol instead of two.
  std::vector<uint64_t> sym_tt;
};

// Per-thread encoder scratch (same rationale as DecScratch: a tl=16
// ctable is 256 KB — fresh allocation per frame costs page faults).
struct EncScratch {
  CTable ct;
  std::vector<uint32_t> cumul;
  std::vector<uint32_t> counts;  // histogram, cleared after use
};
static EncScratch& enc_scratch() {
  thread_local EncScratch s;
  return s;
}

static bool build_ctable(const Norm& nm, CTable& ct,
                         std::vector<uint16_t>& tbl,
                         std::vector<uint32_t>& cumul) {
  uint32_t ts = 1u << nm.table_log;
  if (!spread(nm, tbl)) return false;
  // cumulative starts per symbol (low-prob = 1 slot)
  cumul.assign(nm.symbol_len + 1, 0);
  for (int i = 0; i < nm.symbol_len; i++) {
    uint32_t sz = nm.norm[i] == -1 ? 1 : (nm.norm[i] > 0 ? (uint32_t)nm.norm[i] : 0);
    cumul[i + 1] = cumul[i] + sz;
  }
  if (cumul[nm.symbol_len] != ts) return false;
  ct.state_table.resize(ts);
  // cumul doubles as the fill cursor (not needed afterwards).
  for (uint32_t u = 0; u < ts; u++) ct.state_table[cumul[tbl[u]]++] = ts + u;
  ct.sym_tt.assign(nm.symbol_len, 0);
  int32_t total = 0;
  uint32_t tl_term = (((uint32_t)nm.table_log << 16) - (1u << nm.table_log));
  auto pack_tt = [](int32_t find, uint32_t nb) {
    return ((uint64_t)(uint32_t)find << 32) | nb;
  };
  for (int i = 0; i < nm.symbol_len; i++) {
    int32_t v = nm.norm[i];
    if (v == 0) continue;
    if (v == -1 || v == 1) {
      ct.sym_tt[i] = pack_tt(total - 1, tl_term);
      total += 1;
    } else {
      uint32_t max_bits = nm.table_log - high_bit((uint32_t)(v - 1));
      uint32_t min_state_plus = (uint32_t)v << max_bits;
      ct.sym_tt[i] = pack_tt(total - v, (max_bits << 16) - min_state_plus);
      total += v;
    }
  }
  return total == (int32_t)ts;
}

// ───────────────────── N-state tANS codec ─────────────────────

// Backwards N-lane encode loop, templated so each lane state lives in a
// register and the lane index is static in the unrolled group body.
template <int NS>
static void fse_encode_loop(const uint16_t* src, size_t n, const CTable& ct,
                            uint32_t table_size, BitWriter& bw,
                            uint32_t* states) {
  const uint64_t* tt = ct.sym_tt.data();
  const uint32_t* stt = ct.state_table.data();
  uint32_t st[NS];
  for (int l = 0; l < NS; l++) st[l] = table_size;
  int64_t i = (int64_t)n - 1;
  // Tail first (the encoder walks backwards): indices >= full.
  const int64_t full = (int64_t)(n - n % NS);
  for (; i >= full; i--) {
    uint32_t x = st[i & (NS - 1)];
    uint64_t e = tt[src[i]];
    uint32_t nb = (x + (uint32_t)e) >> 16;
    bw.add_fast(x, nb);
    st[i & (NS - 1)] = stt[(x >> nb) + (int32_t)(e >> 32)];
  }
  // Main: NS symbols per group, static lanes NS-1..0.
  for (; i >= NS - 1; i -= NS) {
#pragma GCC unroll 8
    for (int l = 0; l < NS; l++) {
      uint32_t x = st[NS - 1 - l];
      uint64_t e = tt[src[i - l]];
      uint32_t nb = (x + (uint32_t)e) >> 16;
      bw.add_fast(x, nb);
      st[NS - 1 - l] = stt[(x >> nb) + (int32_t)(e >> 32)];
    }
  }
  for (int l = 0; l < NS; l++) states[l] = st[l];
}

static bool fse_encode_bits(const uint16_t* src, size_t n, const Norm& nm,
                            int n_states, std::vector<uint8_t>& bits) {
  CTable& ct = enc_scratch().ct;
  if (!build_ctable(nm, ct, scratch().spread_tbl, enc_scratch().cumul))
    return false;
  uint32_t table_size = 1u << nm.table_log;
  uint32_t states[8];
  BitWriter bw;
  bw.reserve_values(n + 8);
  switch (n_states) {
    case 1: fse_encode_loop<1>(src, n, ct, table_size, bw, states); break;
    case 2: fse_encode_loop<2>(src, n, ct, table_size, bw, states); break;
    case 4: fse_encode_loop<4>(src, n, ct, table_size, bw, states); break;
    case 8: fse_encode_loop<8>(src, n, ct, table_size, bw, states); break;
    default: return false;
  }
  for (int lane = n_states - 1; lane >= 0; lane--) bw.add(states[lane], nm.table_log);
  bw.close();
  bits = std::move(bw.out);
  return true;
}

// Counted decode hot loop, templated per lane count so every lane state
// lives in a register.  Bit reads are BRANCHLESS: an unconditional
// 8-byte window load at the absolute bit position (the buffer is padded
// 8 bytes on both sides), so there is no refill branch to mispredict —
// this loop sets the native tier's throughput.
template <int NS>
static void fse_counted_loop(const uint64_t* pkd, const uint8_t* base,
                             int64_t pos, uint32_t* st_in, uint16_t* op,
                             int64_t count) {
  uint32_t st[NS];
  for (int l = 0; l < NS; l++) st[l] = st_in[l];
  int64_t i = 0;
  int64_t full = count - count % NS;
  // Fast chunks: one bits-remaining check per CHUNK symbols, then
  // unchecked window loads.  A symbol consumes at most maxTableLog=16
  // bits (nbBits in the dtable is <= tableLog), so pos >= CHUNK*16
  // guarantees the whole chunk stays inside the padded buffer; the
  // serial pos chain in the body is then a bare `pos -= nbits`.
  constexpr int64_t CHUNK = 32;
  static_assert(CHUNK % NS == 0);
  while (i + CHUNK <= full && pos >= CHUNK * 16) {
    for (int64_t k = 0; k < CHUNK; k += NS) {
#pragma GCC unroll 8
      for (int l = 0; l < NS; l++) {
        uint64_t e = pkd[st[l]];
        unsigned nbits = (unsigned)(e & 0xFF);
        op[i + k + l] = (uint16_t)(e >> 16);
        pos -= nbits;
        int64_t wbyte = (pos >> 3) - 3;
        uint64_t win;
        std::memcpy(&win, base + wbyte, 8);
#if defined(__BMI2__)
        uint32_t val = _bzhi_u32((uint32_t)(win >> (pos - wbyte * 8)), nbits);
#else
        uint32_t val = (uint32_t)(win >> (pos - wbyte * 8)) & ((1u << nbits) - 1);
#endif
        st[l] = (uint32_t)(e >> 32) + val;
      }
    }
    i += CHUNK;
  }
  for (; i < full; i += NS) {
#pragma GCC unroll 8
    for (int l = 0; l < NS; l++) {
      uint64_t e = pkd[st[l]];
      unsigned nbits = (unsigned)(e & 0xFF);
      op[i + l] = (uint16_t)(e >> 16);
      pos -= nbits;
      pos = pos < -32 ? -32 : pos;  // corrupt/exhausted: park in the
      //                               front pad (cmov, stays branchless)
      int64_t wbyte = (pos >> 3) - 3;
      uint64_t win;
      std::memcpy(&win, base + wbyte, 8);
      uint32_t val = (uint32_t)(win >> (pos - wbyte * 8)) & ((1u << nbits) - 1);
      st[l] = (uint32_t)(e >> 32) + val;
    }
  }
  for (int l = 0; i < count; i++, l++) {
    uint64_t e = pkd[st[l]];
    unsigned nbits = (unsigned)(e & 0xFF);
    op[i] = (uint16_t)(e >> 16);
    pos -= nbits;
    pos = pos < -32 ? -32 : pos;
    int64_t wbyte = (pos >> 3) - 3;
    uint64_t win;
    std::memcpy(&win, base + wbyte, 8);
    uint32_t val = (uint32_t)(win >> (pos - wbyte * 8)) & ((1u << nbits) - 1);
    st[l] = (uint32_t)(e >> 32) + val;
  }
}

// Decode `count` symbols with N lanes; count<0 => 1-state implicit end.
// `limit` bounds the output size (reference DecompressLimit): counted
// streams whose untrusted count header exceeds it are rejected before
// any allocation.
static bool fse_decode_bits(const uint8_t* bits, size_t blen, const DTable& dt,
                            int table_log, int n_states, int64_t count,
                            int64_t limit, std::vector<uint16_t>& out) {
  if (blen == 0 || blen > ((size_t)1 << 31)) return false;
  if (count > limit) return false;
  // Pad both ends so the 8-byte read window is always in-buffer (the
  // window can reach past the last byte near the stream top).  The
  // padded copy lives in per-thread scratch (no allocation per call).
  std::vector<uint8_t>& buf = scratch().buf;
  if (buf.size() < blen + 16) buf.resize(blen + 16);
  std::memset(buf.data(), 0, 8);
  std::memcpy(buf.data() + 8, bits, blen);
  std::memset(buf.data() + 8 + blen, 0, 8);
  BitReader br;
  if (!br.init(buf.data() + 8, blen)) return false;

  const uint64_t* pk = dt.data();

  if (count >= 0) {
    uint32_t st[8];
    for (int l = 0; l < n_states; l++) st[l] = br.get(table_log);
    out.resize((size_t)count);
    uint16_t* op = out.data();
    int64_t pos = br.pos;
    switch (n_states) {
      case 1: fse_counted_loop<1>(pk, br.data, pos, st, op, count); break;
      case 2: fse_counted_loop<2>(pk, br.data, pos, st, op, count); break;
      case 4: fse_counted_loop<4>(pk, br.data, pos, st, op, count); break;
      case 8: fse_counted_loop<8>(pk, br.data, pos, st, op, count); break;
      default: return false;
    }
    return true;
  }
  uint32_t x = br.get(table_log);
  out.clear();
  while (true) {
    uint64_t e = pk[x];
    uint8_t nb = (uint8_t)(e & 0xFF);
    uint16_t sym = (uint16_t)(e >> 16);
    if (br.pos <= 0 && nb > 0) {
      if (x != 0) out.push_back(sym);
      break;
    }
    out.push_back(sym);
    x = (uint32_t)(e >> 32) + br.get(nb);
    if ((int64_t)out.size() > limit) return false;
  }
  return true;
}

// rANS decode table: linear slot-sequential fill.
static bool build_rans_dtable(const Norm& nm, DTable& dt) {
  uint32_t ts = 1u << nm.table_log;
  dt.resize(ts);
  uint32_t slot = 0;
  for (int s = 0; s < nm.symbol_len; s++) {
    int32_t v = nm.norm[s];
    if (v <= 0) continue;
    for (int32_t j = 0; j < v; j++) {
      uint32_t x = (uint32_t)v + (uint32_t)j;
      int nbb = nm.table_log - high_bit(x);
      uint32_t base = (x << nbb) - ts;
      if (base >= ts || slot >= ts) return false;
      dt[slot] = dt_pack(base, (uint16_t)s, (uint8_t)nbb);
      slot++;
    }
  }
  for (int s = 0; s < nm.symbol_len; s++) {
    if (nm.norm[s] != -1) continue;
    if (slot >= ts) return false;
    dt[slot] = dt_pack(0, (uint16_t)s, (uint8_t)nm.table_log);
    slot++;
  }
  return slot == ts;
}

// ───────────────────── RLE + predictors ─────────────────────

// Buffered RLE state machine — semantics frozen by the stream format
// (byte-identical to the host tier's RleEncoder; see format-freeze
// tests).  Buffer and output are flat arrays with a write pointer: the
// hot path is branch + store, no container bookkeeping.  Worst case
// output: one literal header per (mid-2) symbols plus the flush block,
// covered by size_for().
struct Rle {
  // Uninitialized flat output (resize would zero-fill 2n words per
  // frame); data() + size() after compress().
  std::unique_ptr<uint16_t[]> out;
  uint16_t* op = nullptr;
  size_t out_len = 0;
  uint32_t mid;

  // 2n covers even degenerate mids (mid<=1 emits a header per symbol).
  static size_t size_for(size_t n_tokens) { return 2 * n_tokens + 64; }

  const uint16_t* data() const { return out.get(); }
  size_t size() const { return out_len; }

  void init(uint16_t max_value, size_t n_tokens) {
    int depth = max_value ? high_bit(max_value) + 1 : 1;
    mid = (1u << (depth - 1)) - 1;
    out.reset(new uint16_t[size_for(n_tokens)]);
    op = out.get();
    *op++ = max_value;
    out_len = 0;
  }

  // Whole-stream encode.  The reference machine's buffer is always the
  // most recent window of the input, so the state collapses to a window
  // start j plus the same-run flag — flushes memcpy straight from the
  // token array and the per-symbol path touches no buffer at all
  // (rlecompressu16.go:24-83 semantics, bit-identical blocks).
  void compress(const uint16_t* t, size_t n) {
    size_t j = 0;      // window start: buffered symbols are t[j, i)
    bool sm = false;   // in a same-run
    uint16_t p1 = 0, p = 0;  // last two symbols (valid once i-j >= 2)
    const size_t ovf = (size_t)(uint32_t)(mid - 1);  // mid==0 never fires
    for (size_t i = 0; i < n; i++) {
      uint16_t s = t[i];
      size_t bn = i - j;
      if (bn >= 2) {
        if (p1 == p && p == s) {
          if (!sm && bn > 2) {  // diff prefix flushes, keep last two
            *op++ = (uint16_t)(mid + bn - 2);
            std::memcpy(op, t + j, (bn - 2) * 2);
            op += bn - 2;
            j = i - 2;
          }
          sm = true;
        } else {
          if (sm && bn > 2) {  // same-run ended: count + value
            *op++ = (uint16_t)bn;
            *op++ = t[j];
            j = i;
          }
          sm = false;
        }
        bn = i - j;
        if (bn >= ovf) {  // count overflow: flush all but last two
          if (sm) {
            *op++ = (uint16_t)(bn - 2);
            *op++ = t[j];
          } else {
            *op++ = (uint16_t)(mid + bn - 2);
            std::memcpy(op, t + j, (bn - 2) * 2);
            op += bn - 2;
          }
          j = i - 2;
        }
      }
      p1 = p;
      p = s;
    }
    size_t bn = n - j;
    if (bn) {
      if (sm) {
        *op++ = (uint16_t)bn;
        *op++ = t[j];
      } else {
        *op++ = (uint16_t)(mid + bn);
        std::memcpy(op, t + j, bn * 2);
        op += bn;
      }
    }
    out_len = (size_t)(op - out.get());
  }
};

// Expand RLE blocks beginning at in[start]; stops when input exhausts.
// Truncated trailing blocks (corrupt streams) are clamped/dropped rather
// than read past the buffer; the caller's token-count check rejects the
// short expansion, matching the Python tier's error on truncation.
// ``max_out`` bounds the expansion (the caller knows the legitimate
// token count: 1 + pixels + escapes <= 1 + 2*pixels).  Without it a
// crafted blob of same-run blocks with mid=0x7FFF could amplify a
// DecompressLimit-sized word stream into tens of GB of tokens before
// the downstream token-count check ever ran.
static void rle_expand(const uint16_t* in, size_t n, size_t start, uint32_t mid,
                       size_t max_out, std::vector<uint16_t>& out) {
  size_t i = start;
  while (i < n && out.size() < max_out) {
    uint32_t c = in[i++];
    if (c > mid) {
      size_t k = c - mid;
      if (k > n - i) k = n - i;  // truncated literal run: clamp
      if (k > max_out - out.size()) k = max_out - out.size();
      out.insert(out.end(), in + i, in + i + k);
      i += k;
    } else {
      if (i >= n) break;  // truncated same-run: value word missing
      uint16_t v = in[i++];
      size_t k = c;
      if (k > max_out - out.size()) k = max_out - out.size();
      out.insert(out.end(), k, v);
    }
  }
}

enum Pred { PRED_AVG = 0, PRED_GRAD = 1, PRED_MED = 2, PRED_ZZ = 3 };

static inline int32_t grad_predict(int32_t w, int32_t n, int32_t nw, int32_t ne) {
  int32_t avg = (w + n) >> 1;
  int32_t gw = w - nw; if (gw < 0) gw = -gw;
  int32_t gn = n - nw; if (gn < 0) gn = -gn;
  int32_t g = gw + gn;
  if (g == 0) return avg;
  int32_t corr = (ne - nw) >> 3;
  int32_t lim = g >> 1;
  if (corr > lim) corr = lim;
  if (corr < -lim) corr = -lim;
  return avg + corr;
}
static inline int32_t med_predict(int32_t a, int32_t b, int32_t c) {
  if (c >= a && c >= b) return a < b ? a : b;
  if (c <= a && c <= b) return a > b ? a : b;
  return a + b - c;
}

// Invert the escaped residual stream into pixels.
// tokens[0] is maxValue; pixels follow.  Templated per predictor with
// boundary rows/columns peeled out of the interior loop.
template <int KIND>
static bool predictor_inverse_t(const uint16_t* tokens, size_t n_tokens, int width,
                                int height, uint16_t* out) {
  if (n_tokens < (size_t)width * height + 1) return false;
  uint16_t max_value = tokens[0];
  int depth = max_value ? high_bit(max_value) + 1 : 1;
  const int32_t thr = (1 << (depth - 1)) - 1;
  const uint16_t delim = (uint16_t)((1u << depth) - 1);
  const uint16_t* tp = tokens + 1;

  if (KIND == PRED_ZZ) {
    for (int y = 0; y < height; y++) {
      uint16_t* row = out + (size_t)y * width;
      int32_t prev = 0;
      for (int x = 0; x < width; x++) {
        uint16_t v = *tp++;
        if (v == delim) {
          prev = *tp++;
        } else {
          prev = (uint16_t)(prev + ((int32_t)(v >> 1) ^ -(int32_t)(v & 1)));
        }
        row[x] = (uint16_t)prev;
      }
    }
    return true;
  }

  // Row 0: left-only chain.
  {
    uint16_t v = *tp++;
    out[0] = v == delim ? *tp++ : (uint16_t)((int32_t)v - thr);
    for (int x = 1; x < width; x++) {
      uint16_t t = *tp++;
      out[x] = t == delim ? *tp++ : (uint16_t)((int32_t)out[x - 1] + (int32_t)t - thr);
    }
  }
  for (int y = 1; y < height; y++) {
    uint16_t* row = out + (size_t)y * width;
    const uint16_t* up = row - width;
    {
      uint16_t t = *tp++;
      row[0] = t == delim ? *tp++ : (uint16_t)((int32_t)up[0] + (int32_t)t - thr);
    }
    int32_t left = row[0];
    for (int x = 1; x < width; x++) {
      uint16_t t = *tp++;
      if (t == delim) {
        left = *tp++;
      } else {
        int32_t pred;
        if (KIND == PRED_AVG) {
          pred = (left + (int32_t)up[x]) >> 1;
        } else if (KIND == PRED_GRAD) {
          int32_t ne = x + 1 < width ? (int32_t)up[x + 1] : (int32_t)up[x - 1];
          pred = grad_predict(left, up[x], up[x - 1], ne);
        } else {
          pred = med_predict(left, up[x], up[x - 1]);
        }
        left = (uint16_t)(pred + (int32_t)t - thr);
      }
      row[x] = (uint16_t)left;
    }
  }
  return true;
}

static bool predictor_inverse(const uint16_t* tokens, size_t n_tokens, int width,
                              int height, int kind, uint16_t* out) {
  // The token stream length varies with escapes; the templated loops read
  // exactly one token per pixel plus one per escape, and rle_expand
  // produced the full expansion, so a short stream means corruption.
  // Recompute the minimal check: at least width*height tokens + 1.
  if (n_tokens < (size_t)width * height + 1) return false;
  switch (kind) {
    case PRED_AVG: return predictor_inverse_t<PRED_AVG>(tokens, n_tokens, width, height, out);
    case PRED_GRAD: return predictor_inverse_t<PRED_GRAD>(tokens, n_tokens, width, height, out);
    case PRED_MED: return predictor_inverse_t<PRED_MED>(tokens, n_tokens, width, height, out);
    case PRED_ZZ: return predictor_inverse_t<PRED_ZZ>(tokens, n_tokens, width, height, out);
  }
  return false;
}

// Forward predictor: pixels -> escaped residual tokens (incl leading maxValue).
// Forward predictor, templated per kind with boundary rows/cols peeled
// (the encode mirror of predictor_inverse_t).  Emission goes through a
// raw pointer — worst case is 2 tokens per pixel, sized up front.
template <int KIND>
static void predictor_forward_t(const uint16_t* px, int width, int height,
                                uint16_t max_value, std::vector<uint16_t>& tokens) {
  int depth = max_value ? high_bit(max_value) + 1 : 1;
  const int32_t thr = (1 << (depth - 1)) - 1;
  const uint16_t delim = (uint16_t)((1u << depth) - 1);
  tokens.resize((size_t)width * height * 2 + 2);
  uint16_t* tp = tokens.data();
  *tp++ = max_value;

  auto emit = [&](int32_t diff, uint16_t raw) {
    int32_t ad = diff < 0 ? -diff : diff;
    if (ad >= thr) {
      *tp++ = delim;
      *tp++ = raw;
    } else if (KIND == PRED_ZZ) {
      *tp++ = (uint16_t)((((uint32_t)diff << 1) ^ (uint32_t)(diff >> 31)) & 0xFFFF);
    } else {
      *tp++ = (uint16_t)(thr + diff);
    }
  };

  // Row 0: left-only (zz: left with zigzag; first pixel pred 0).
  emit((int32_t)px[0], px[0]);
  for (int x = 1; x < width; x++) emit((int32_t)px[x] - px[x - 1], px[x]);

  for (int y = 1; y < height; y++) {
    const uint16_t* row = px + (size_t)y * width;
    const uint16_t* up = row - width;
    if (KIND == PRED_ZZ) {
      emit((int32_t)row[0], row[0]);
      for (int x = 1; x < width; x++) emit((int32_t)row[x] - row[x - 1], row[x]);
      continue;
    }
    emit((int32_t)row[0] - up[0], row[0]);
    int x = 1;
    const int last = width - 1;
    for (; x < last; x++) {
      int32_t pred;
      if (KIND == PRED_AVG) pred = ((int32_t)row[x - 1] + up[x]) >> 1;
      else if (KIND == PRED_GRAD) pred = grad_predict(row[x - 1], up[x], up[x - 1], up[x + 1]);
      else pred = med_predict(row[x - 1], up[x], up[x - 1]);
      emit((int32_t)row[x] - pred, row[x]);
    }
    if (x == last) {  // NE falls back to NW at the right edge
      int32_t pred;
      if (KIND == PRED_AVG) pred = ((int32_t)row[x - 1] + up[x]) >> 1;
      else if (KIND == PRED_GRAD) pred = grad_predict(row[x - 1], up[x], up[x - 1], up[x - 1]);
      else pred = med_predict(row[x - 1], up[x], up[x - 1]);
      emit((int32_t)row[x] - pred, row[x]);
    }
  }
  tokens.resize(tp - tokens.data());
}

static void predictor_forward(const uint16_t* px, int width, int height,
                              uint16_t max_value, int kind,
                              std::vector<uint16_t>& tokens) {
  switch (kind) {
    case PRED_AVG: predictor_forward_t<PRED_AVG>(px, width, height, max_value, tokens); return;
    case PRED_GRAD: predictor_forward_t<PRED_GRAD>(px, width, height, max_value, tokens); return;
    case PRED_MED: predictor_forward_t<PRED_MED>(px, width, height, max_value, tokens); return;
    case PRED_ZZ: predictor_forward_t<PRED_ZZ>(px, width, height, max_value, tokens); return;
  }
  tokens.clear();
}

// ───────────────────── top-level codecs ─────────────────────

static bool entropy_compress(const uint16_t* syms, size_t n, int n_states,
                             std::vector<uint8_t>& out) {
  if ((int64_t)n <= (n_states > 1 ? n_states - 1 : 1)) return false;
  // Reused histogram buffer: zeroed on first use, then only the touched
  // prefix [0, sl) is cleared on scope exit (256 KB calloc per call
  // otherwise).  Two interleaved half-histograms break the dependent
  // increment chain on repeated symbols (the reference's dual-buffer
  // trick, asm_amd64.s countSimpleU16Asm); merged into the low half.
  std::vector<uint32_t>& counts = enc_scratch().counts;
  if (counts.size() < 2 * (kMaxSymbol + 1)) counts.assign(2 * (kMaxSymbol + 1), 0);
  uint32_t* c0 = counts.data();
  uint32_t* c1 = c0 + (kMaxSymbol + 1);
  size_t i = 0;
  uint16_t smax = 0;
  for (; i + 2 <= n; i += 2) {
    uint16_t a = syms[i], b = syms[i + 1];
    c0[a]++;
    c1[b]++;
    uint16_t m = a > b ? a : b;
    smax = m > smax ? m : smax;
  }
  if (i < n) {
    c0[syms[i]]++;
    smax = syms[i] > smax ? syms[i] : smax;
  }
  int sl = (int)smax + 1;
  uint32_t maxc = 0;
  for (int s = 0; s < sl; s++) {
    c0[s] += c1[s];
    if (c0[s] > maxc) maxc = c0[s];
  }
  struct ClearGuard {
    uint32_t* c0;
    uint32_t* c1;
    int sl;
    ~ClearGuard() {
      std::memset(c0, 0, (size_t)sl * 4);
      std::memset(c1, 0, (size_t)sl * 4);
    }
  } guard{c0, c1, sl};
  if (maxc == n) return false;                 // UseRLE
  if (maxc == 1 || maxc < (n >> 15)) return false;  // Incompressible
  Norm nm;
  nm.symbol_len = sl;
  nm.table_log = optimal_table_log(11, (int64_t)n, sl);
  if (!normalize(counts.data(), (int64_t)n, nm)) return false;
  if (!validate_norm(nm)) return false;
  std::vector<uint8_t> hdr;
  if (!write_count(nm, hdr)) return false;
  std::vector<uint8_t> bits;
  if (!fse_encode_bits(syms, n, nm, n_states, bits)) return false;
  size_t body = hdr.size() + bits.size();
  if (body >= n * 2) return false;
  out.clear();
  if (n_states > 1) {
    uint8_t magic1 = n_states == 2 ? 0x02 : (n_states == 4 ? 0x04 : 0x84);
    out.push_back(0xFF);
    out.push_back(magic1);
    uint32_t cnt = (uint32_t)n;
    out.insert(out.end(), (uint8_t*)&cnt, (uint8_t*)&cnt + 4);
  }
  out.insert(out.end(), hdr.begin(), hdr.end());
  out.insert(out.end(), bits.begin(), bits.end());
  return true;
}

static bool entropy_decompress(const uint8_t* blob, size_t len, int64_t limit,
                               std::vector<uint16_t>& out) {
  int n_states = 1;
  int64_t count = -1;
  bool rans = false;
  size_t off = 0;
  if (len >= 6 && blob[0] == 0xFF) {
    uint8_t m = blob[1];
    if (m == 0x84) { n_states = 8; }
    else if (m == 0x08) { n_states = 8; rans = true; }
    else if (m == 0x04) { n_states = 4; }
    else if (m == 0x02) { n_states = 2; }
    if (m == 0x84 || m == 0x08 || m == 0x04 || m == 0x02) {
      uint32_t c;
      std::memcpy(&c, blob + 2, 4);
      count = c;
      off = 6;
    }
  }
  if (off >= len) return false;
  Norm& nm = scratch().nm;
  size_t consumed = 0;
  if (!read_ncount(blob + off, len - off, nm, &consumed)) return false;
  if (off + consumed >= len) return false;
  DTable& dt = scratch().dt;
  if (rans ? !build_rans_dtable(nm, dt)
           : !build_dtable(nm, dt, scratch().spread_tbl))
    return false;
  return fse_decode_bits(blob + off + consumed, len - off - consumed, dt,
                         nm.table_log, n_states, count, limit, out);
}

}  // namespace

// ───────────────────────── C ABI ─────────────────────────

extern "C" {

// Fast normalized-count header reader for the Python tiers (the pure-
// Python nibble state machine costs ~1ms per strip; this is ~1000x
// faster).  Fills out_norm (norm_cap >= symbol_len int32 slots, -1 kept
// for low-prob symbols) and out_meta[0]=symbol_len, out_meta[1]=table_log.
// Returns bytes consumed, or 0 on failure.
size_t mic_read_ncount(const uint8_t* data, size_t len, int32_t* out_norm,
                       size_t norm_cap, int32_t* out_meta) {
  Norm nm;
  size_t consumed = 0;
  if (!read_ncount(data, len, nm, &consumed)) return 0;
  if ((size_t)nm.symbol_len > norm_cap) return 0;
  for (int i = 0; i < nm.symbol_len; i++) out_norm[i] = nm.norm[i];
  out_meta[0] = nm.symbol_len;
  out_meta[1] = nm.table_log;
  return consumed;
}

// Full single-frame decode: entropy -> RLE expand -> predictor inverse.
// kind: 0=avg, 1=grad, 2=med, 3=zz.  Returns 0 on success.
int mic_decompress_frame(const uint8_t* blob, size_t len, int width, int height,
                         int kind, uint16_t* out_pixels) {
  if (width <= 0 || height <= 0) return 4;
  std::vector<uint16_t>& rle = scratch().rle;
  // A valid RLE stream for w*h pixels is bounded by 2*tokens + 2 words
  // (tokens <= 2*w*h + 1 with escapes); reject counts past that before
  // allocating (DecompressLimit analog, fse_codec.py:64).
  int64_t limit = (int64_t)4 * width * height + 16;
  if (!entropy_decompress(blob, len, limit, rle)) return 1;
  if (rle.size() < 2) return 2;
  uint16_t rle_max = rle[0];
  int depth = rle_max ? high_bit(rle_max) + 1 : 1;
  uint32_t mid = (1u << (depth - 1)) - 1;
  std::vector<uint16_t>& tokens = scratch().tokens;
  tokens.clear();
  tokens.reserve((size_t)width * height * 2 + 2);
  rle_expand(rle.data(), rle.size(), 1, mid, (size_t)width * height * 2 + 2,
             tokens);
  size_t n_tok = tokens.size();
  tokens.push_back(0);  // over-read pads: corrupt escape-heavy streams
  tokens.push_back(0);  // read zeros instead of past the buffer
  if (!predictor_inverse(tokens.data(), n_tok, width, height, kind, out_pixels))
    return 3;
  return 0;
}

// Full single-frame encode.  n_states in {1,2,4,8}; falls back down the
// chain exactly like the orchestrators.  Returns compressed length or 0.
size_t mic_compress_frame(const uint16_t* pixels, int width, int height,
                          uint16_t max_value, int kind, int n_states,
                          uint8_t* out, size_t out_cap) {
  // Per-thread scratch: resize is amortized across frames, so the 2x
  // worst-case token buffer is neither re-zeroed nor re-mapped per call.
  std::vector<uint16_t>& tokens = scratch().enc_tokens;
  predictor_forward(pixels, width, height, max_value, kind, tokens);
  int depth = max_value ? high_bit(max_value) + 1 : 1;
  uint16_t delim = (uint16_t)((1u << depth) - 1);
  Rle rle;
  rle.init(delim, tokens.size());
  rle.compress(tokens.data(), tokens.size());
  std::vector<uint8_t> blob;
  for (int ns = n_states; ns >= 1; ns >>= 1) {
    if (entropy_compress(rle.data(), rle.size(), ns, blob)) {
      if (blob.size() > out_cap) return 0;
      std::memcpy(out, blob.data(), blob.size());
      return blob.size();
    }
  }
  return 0;
}

// Raw entropy coding of a u16 symbol stream.
size_t mic_entropy_compress(const uint16_t* syms, size_t n, int n_states,
                            uint8_t* out, size_t out_cap) {
  std::vector<uint8_t> blob;
  if (!entropy_compress(syms, n, n_states, blob)) return 0;
  if (blob.size() > out_cap) return 0;
  std::memcpy(out, blob.data(), blob.size());
  return blob.size();
}

size_t mic_entropy_decompress(const uint8_t* blob, size_t len, uint16_t* out,
                              size_t out_cap) {
  std::vector<uint16_t> o;
  if (!entropy_decompress(blob, len, (int64_t)out_cap, o)) return 0;
  if (o.size() > out_cap) return 0;
  std::memcpy(out, o.data(), o.size() * 2);
  return o.size();
}

int mic_native_version() { return 1; }

// Normalize counts to 2^table_log and emit the ncount header in one
// call — the Python tiers' per-strip encode setup (normalize_count +
// write_count dominated micw_compress once the lane loop went native).
// out_norm: i32[symbol_len]; out_hdr: header bytes (cap out_cap).
// Returns header length, or 0 on failure (infeasible normalization /
// header overflow).
size_t mic_normalize_write_count(const uint32_t* counts, int64_t total,
                                 int table_log, int symbol_len,
                                 int32_t* out_norm, uint8_t* out_hdr,
                                 size_t out_cap) {
  if (symbol_len <= 0 || total <= 0 || table_log < kMinTableLog ||
      table_log > kMaxTableLog)
    return 0;
  Norm nm;
  nm.symbol_len = symbol_len;
  nm.table_log = table_log;
  nm.norm.assign((size_t)symbol_len, 0);
  if (!normalize(counts, total, nm)) return 0;
  if (!validate_norm(nm)) return 0;
  std::vector<uint8_t> hdr;
  if (!write_count(nm, hdr)) return 0;
  if (hdr.size() > out_cap) return 0;
  std::memcpy(out_norm, nm.norm.data(), (size_t)symbol_len * 4);
  std::memcpy(out_hdr, hdr.data(), hdr.size());
  return hdr.size();
}

// Reverse lane-interleaved rANS encode — the MICT (FF 57) / alias
// (FF 41) hot loop, mirroring device_rans._lane_encode bit for bit
// (same renorm discipline, same word order: steps ascending, lanes
// ascending within a step).  The numpy form pays per-step vector-call
// overhead (~3.5 MB/s whole-pipeline); this scalar loop removes the
// transcode-ingest bottleneck.
//
// syms: u16[n]; freq_of/cumul_of: u32 indexed BY SYMBOL VALUE;
// slot_of: u32[2^tl] alias permutation or NULL for the standard
// layout.  out_states: u32[lanes]; out_words: u16[max_words]
// (max_words >= n is always sufficient: <=1 word per symbol).
// Returns the word count, or (size_t)-1 on error (zero frequency =
// corrupt tables, or word-buffer overflow).
size_t mic_lane_encode(const uint16_t* syms, size_t n, int lanes, int tl,
                       const uint32_t* freq_of, const uint32_t* cumul_of,
                       const uint32_t* slot_of, uint32_t* out_states,
                       uint16_t* out_words, size_t max_words) {
  if (lanes <= 0 || lanes > 4096 || tl < 1 || tl > 15) return (size_t)-1;
  const int L = lanes;
  const uint32_t shift = 32 - (uint32_t)tl;
  std::vector<uint32_t> x((size_t)L, 1u << 16);
  const size_t n_steps = (n + (size_t)L - 1) / (size_t)L;
  size_t wpos = max_words;  // fill backward; blocks land steps-ascending
  std::vector<uint16_t> wtmp((size_t)L);
  for (size_t t = n_steps; t-- > 0;) {
    const size_t base = t * (size_t)L;
    const int cnt = (int)(n - base < (size_t)L ? n - base : (size_t)L);
    int k = 0;
    for (int l = 0; l < cnt; l++) {
      const uint32_t s = syms[base + l];
      const uint32_t f = freq_of[s];
      if (f == 0) return (size_t)-1;
      uint32_t xv = x[l];
      if ((uint64_t)xv >= ((uint64_t)f << shift)) {  // single-word renorm
        wtmp[k++] = (uint16_t)(xv & 0xFFFF);
        xv >>= 16;
      }
      const uint32_t q = xv / f, r = xv - q * f;
      const uint32_t st = slot_of ? slot_of[r + cumul_of[s]]
                                  : r + cumul_of[s];
      x[l] = (q << tl) + st;
    }
    if ((size_t)k > wpos) return (size_t)-1;
    wpos -= (size_t)k;
    std::memcpy(out_words + wpos, wtmp.data(), (size_t)k * 2);
  }
  const size_t n_words = max_words - wpos;
  std::memmove(out_words, out_words + wpos, n_words * 2);
  std::memcpy(out_states, x.data(), (size_t)L * 4);
  return n_words;
}


// Threaded PICS container ENCODE — the mirror of mic_decompress_strips
// (reference CompressParallelStrips goroutine pool, parallelstrips.go:55;
// C encoder role: mic_compress_c.c).  Strip geometry and byte layout
// match parallel/strips.py exactly: stripH = ceil(h/numStrips), last
// strip short, 20-byte header + 8-byte table entries + blobs.  Each
// worker encodes into its own buffer (per-thread scratch applies), the
// assembly is a straight concat.  Returns total container length, or 0
// if any strip fails (caller falls back to the Python tier, which
// raises the matching error).
// Persistent worker pool for the strip paths.  Per-call std::thread
// spawn cost (~0.5 ms for 8 workers) exceeded the decode time of a
// 0.5 MB image's strips, making PICS-C decode SLOWER than single-frame
// on typical DICOM sizes; the reference amortizes this with long-lived
// goroutines / a pthread pool (parallelstrips.go:270, mic_parallel.c).
// Workers park on a condition variable between batches; batches are
// serialized (one parallel_for at a time — callers come through
// Python's ctypes layer, which may release the GIL concurrently).
class WorkPool {
  // Per-batch state lives in a shared_ptr so a worker that wakes late
  // (descheduled between the wake and its first item claim) holds the
  // batch it was woken for: its exhausted counter makes the stale
  // worker a no-op instead of letting it claim items of a NEWER batch
  // with the older batch's (by then dangling) function reference.
  struct Batch {
    const std::function<void(uint32_t)>* fn;
    std::atomic<uint32_t> next{0}, done{0};
    std::atomic<int> tickets{1};  // the caller holds ticket 0
    uint32_t total = 0;
    int cap = 0;
    std::exception_ptr err;  // first throw from fn (guarded by pool m_)
  };

 public:
  static WorkPool& inst() {
    static WorkPool* p = new WorkPool();  // leaked: no shutdown races
    return *p;
  }

  // Run fn(0..n-1) across the pool; at most max_workers participants
  // (including the calling thread).  Blocks until every item ran, so
  // fn outlives every call a worker can make through this batch.
  void parallel_for(uint32_t n, int max_workers,
                    const std::function<void(uint32_t)>& fn) {
    if (n == 0) return;
    if (max_workers <= 1 || n == 1 || workers_.empty()) {
      for (uint32_t i = 0; i < n; i++) fn(i);
      return;
    }
    std::lock_guard<std::mutex> batch_lk(batch_m_);
    auto b = std::make_shared<Batch>();
    b->fn = &fn;
    b->total = n;
    b->cap = max_workers;
    {
      std::lock_guard<std::mutex> lk(m_);
      cur_ = b;
      gen_++;
    }
    cv_.notify_all();
    consume(*b);
    std::unique_lock<std::mutex> lk(m_);
    // Never unwind past workers still writing through this batch's fn:
    // a throw inside fn is captured in consume (the item still counts
    // as done), the batch drains fully, THEN the first error rethrows.
    cv_done_.wait(lk, [&] { return b->done.load() >= b->total; });
    cur_.reset();
    if (b->err) std::rethrow_exception(b->err);
  }

 private:
  WorkPool() {
    int hw = (int)std::thread::hardware_concurrency();
    if (hw < 1) hw = 1;
    // MIC_POOL_THREADS overrides the pool size — single-core CI hosts
    // would otherwise never exercise the cv-dispatch path at all.
    if (const char* e = std::getenv("MIC_POOL_THREADS")) {
      int v = std::atoi(e);
      if (v >= 1 && v <= 256) hw = v;
    }
    for (int i = 1; i < hw; i++)
      workers_.emplace_back([this] { worker(); });
  }

  void consume(Batch& b) {
    for (;;) {
      uint32_t i = b.next.fetch_add(1);
      if (i >= b.total) return;
      try {
        (*b.fn)(i);
      } catch (...) {
        std::lock_guard<std::mutex> lk(m_);
        if (!b.err) b.err = std::current_exception();
      }
      if (b.done.fetch_add(1) + 1 >= b.total) {
        std::lock_guard<std::mutex> lk(m_);
        cv_done_.notify_all();
      }
    }
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Batch> b;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        b = cur_;
        if (!b || b->tickets.fetch_add(1) >= b->cap) continue;
      }
      consume(*b);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_, batch_m_;
  std::condition_variable cv_, cv_done_;
  std::shared_ptr<Batch> cur_;
  uint64_t gen_ = 0;
};

size_t mic_compress_strips(const uint16_t* pixels, int width, int height,
                           uint16_t max_value, int kind, int n_states,
                           int num_strips, int n_threads,
                           uint8_t* out, size_t out_cap) {
  if (width <= 0 || height <= 0 || num_strips <= 0) return 0;
  if (num_strips > height) num_strips = height;
  uint32_t strip_h = ((uint32_t)height + num_strips - 1) / num_strips;
  uint32_t actual = ((uint32_t)height + strip_h - 1) / strip_h;
  std::vector<std::vector<uint8_t>> blobs(actual);
  std::vector<int> ok(actual, 0);
  int hw = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  WorkPool::inst().parallel_for(actual, n_threads, [&](uint32_t s) {
    uint32_t y0 = s * strip_h;
    uint32_t sh = y0 + strip_h <= (uint32_t)height ? strip_h
                                                   : (uint32_t)height - y0;
    size_t n_px = (size_t)sh * width;
    std::vector<uint8_t>& b = blobs[s];
    b.resize(n_px * 8 + 1024);  // > any accepted blob (body < 2x words)
    size_t ln = mic_compress_frame(pixels + (size_t)y0 * width, width,
                                   (int)sh, max_value, kind, n_states,
                                   b.data(), b.size());
    if (ln == 0) { ok[s] = 0; return; }
    b.resize(ln);
    ok[s] = 1;
  });
  size_t total = 20 + (size_t)actual * 8;
  for (uint32_t s = 0; s < actual; s++) {
    if (!ok[s]) return 0;
    total += blobs[s].size();
  }
  if (total > out_cap) return 0;
  std::memcpy(out, "PICS", 4);
  uint32_t hdr32[4] = {(uint32_t)width, (uint32_t)height, actual, strip_h};
  std::memcpy(out + 4, hdr32, 16);
  uint8_t* tp = out + 20;
  uint8_t* dp = out + 20 + (size_t)actual * 8;
  uint32_t off = 0;
  for (uint32_t s = 0; s < actual; s++) {
    uint32_t ln = (uint32_t)blobs[s].size();
    std::memcpy(tp, &off, 4);
    std::memcpy(tp + 4, &ln, 4);
    tp += 8;
    std::memcpy(dp, blobs[s].data(), ln);
    dp += ln;
    off += ln;
  }
  return total;
}

// Threaded PICS container decode (reference mic_parallel.c pthreads /
// parallelstrips.go:270 worker pool).  kind selects the predictor
// inverse (0=avg for the standard PICS frames).  n_threads <= 0 picks
// hardware_concurrency.  Returns 0 on success, first failing strip's
// error code otherwise.
int mic_decompress_strips(const uint8_t* blob, size_t len, int kind,
                          uint16_t* out_pixels, int n_threads) {
  if (len < 20 || memcmp(blob, "PICS", 4) != 0) return 10;
  uint32_t width, height, ns, strip_h;
  memcpy(&width, blob + 4, 4);
  memcpy(&height, blob + 8, 4);
  memcpy(&ns, blob + 12, 4);
  memcpy(&strip_h, blob + 16, 4);
  size_t hdr = 20 + (size_t)ns * 8;
  if (len < hdr || ns == 0 || strip_h == 0) return 11;
  // Geometry must tile the image exactly: strips [0, ns) at strip_h rows
  // each, last strip possibly short.  Computed in 64-bit so corrupt
  // headers cannot overflow y0 or underflow the last strip's height.
  if ((uint64_t)(ns - 1) * strip_h >= height || (uint64_t)ns * strip_h < height)
    return 11;
  int hw = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  std::vector<int> rc(ns, 0);
  WorkPool::inst().parallel_for(ns, n_threads, [&](uint32_t s) {
    uint32_t off, sl;
    memcpy(&off, blob + 20 + (size_t)s * 8, 4);
    memcpy(&sl, blob + 24 + (size_t)s * 8, 4);
    size_t base = hdr + off;
    if (base + sl > len) { rc[s] = 12; return; }
    uint64_t y0 = (uint64_t)s * strip_h;
    uint32_t sh = (uint32_t)(y0 + strip_h <= height ? strip_h : height - y0);
    rc[s] = mic_decompress_frame(blob + base, sl, (int)width, (int)sh,
                                 kind, out_pixels + (size_t)y0 * width);
  });
  for (uint32_t s = 0; s < ns; s++)
    if (rc[s] != 0) return rc[s];
  return 0;
}

}  // extern "C"
