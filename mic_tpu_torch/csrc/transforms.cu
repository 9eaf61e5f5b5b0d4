// The transform kernels for Hopper: lossless YCoCg-R on u16 planes and the
// 5/3 lifting pass along rows.
//
// ycocgr_fwd_kernel / ycocgr_inv_kernel replace
// mic_tpu/tpu/kernels.py:_ycocgr_fwd_kernel / _ycocgr_inv_kernel (wrappers
// ycocgr_forward_tpu / ycocgr_inverse_tpu).  Per pixel, on three u16
// planes in and three out, arithmetic in int:
//   forward  co = r - b;  t = b + (co >> 1);  cg = g - t;  y = t + (cg >> 1)
//            Co, Cg = zigzag of the low 16 bits of co, cg (as int16);
//            Y = the low 16 bits of y
//   inverse  co, cg = unzigzag (int16) of Co, Cg;  t = y - (cg >> 1)
//            g = cg + t;  b = t - (co >> 1);  r = co + b, low 16 bits each
// For 8-bit RGB nothing wraps; for arbitrary u16 planes the 16-bit
// truncations wrap exactly as the Pallas kernel's astype(int16) and
// astype(uint16) do.  Right shifts of negative values are arithmetic.
//
// wt53_fwd_kernel / wt53_inv_kernel replace
// mic_tpu/tpu/kernels.py:_wt53_fwd_kernel / _wt53_inv_kernel (wrappers
// wt53_rows_forward_tpu / wt53_rows_inverse_tpu).  On a row x of n >= 2
// int32 values, even[i] = x[2i], odd[i] = x[2i + 1], nh = n / 2:
//   d[i] = odd[i] - ((even[i] + even_r[i]) >> 1)        (predict)
//   s[i] = even[i] + ((d[max(i-1,0)] + d[min(i,nh-1)] + 2) >> 2)   (update)
// with even_r[i] = even[i + 1], or even[i] at the right edge of an even n
// (symmetric extension); the output row interleaves s (even slots) and d
// (odd slots).  The inverse undoes the update, then the predict.  Sums
// wrap mod 2^32 (computed unsigned), as jnp's int32 does.
//
// Design.  Both are elementwise passes bound by memory traffic: 12 bytes
// a pixel (YCoCg-R) and 8 bytes an element (lifting).  The Pallas YCoCg-R
// call is one VMEM block with no grid, which caps its size; here a
// grid-stride loop takes any number of pixels, a batch of planes included,
// 8 pixels a thread through 16-byte loads and stores where the six
// pointers are 16-byte aligned, the tail (and unaligned planes) one pixel
// a thread.  The Pallas lifting kernel takes pre-split even / odd halves
// because Mosaic lowers no strided gather; here one thread owns one
// (even, odd) pair of the interleaved row, reads its five neighbours
// directly (they sit in the same or the next cache line) and recomputes
// its neighbours' d (forward) or even (inverse), so no thread waits on
// another and the de-interleave and re-interleave passes around the
// Pallas kernel disappear.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (mic_tpu_torch/_build.py).  Each C entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride above this many blocks

__device__ __forceinline__ uint32_t zigzag16(int v) {
  const int v16 = (int)(int16_t)v;  // low 16 bits, sign-extended
  return (((uint32_t)v16 << 1) ^ (uint32_t)(v16 >> 15)) & 0xFFFFu;
}

__device__ __forceinline__ int unzigzag16(uint32_t u) {
  return (int)(int16_t)((u >> 1) ^ (0u - (u & 1u)));
}

__device__ __forceinline__ void fwd_px(uint32_t r, uint32_t g, uint32_t b, uint32_t& y,
                                       uint32_t& co, uint32_t& cg) {
  const int c0 = (int)r - (int)b;
  const int t = (int)b + (c0 >> 1);
  const int c1 = (int)g - t;
  y = (uint32_t)(t + (c1 >> 1)) & 0xFFFFu;
  co = zigzag16(c0);
  cg = zigzag16(c1);
}

__device__ __forceinline__ void inv_px(uint32_t y, uint32_t co, uint32_t cg, uint32_t& r,
                                       uint32_t& g, uint32_t& b) {
  const int c0 = unzigzag16(co), c1 = unzigzag16(cg);
  const int t = (int)y - (c1 >> 1);
  const int bb = t - (c0 >> 1);
  g = (uint32_t)(c1 + t) & 0xFFFFu;
  b = (uint32_t)bb & 0xFFFFu;
  r = (uint32_t)(c0 + bb) & 0xFFFFu;
}

// Eight u16 pixels of three planes, two to a 32-bit word.
template <bool INV>
__device__ __forceinline__ void vec8(const uint4& a, const uint4& b, const uint4& c, uint4& x,
                                     uint4& y, uint4& z) {
  const uint32_t pa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t pb[4] = {b.x, b.y, b.z, b.w};
  const uint32_t pc[4] = {c.x, c.y, c.z, c.w};
  uint32_t px[4], py[4], pz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t x0, y0, z0, x1, y1, z1;
    if (INV) {
      inv_px(pa[k] & 0xFFFFu, pb[k] & 0xFFFFu, pc[k] & 0xFFFFu, x0, y0, z0);
      inv_px(pa[k] >> 16, pb[k] >> 16, pc[k] >> 16, x1, y1, z1);
    } else {
      fwd_px(pa[k] & 0xFFFFu, pb[k] & 0xFFFFu, pc[k] & 0xFFFFu, x0, y0, z0);
      fwd_px(pa[k] >> 16, pb[k] >> 16, pc[k] >> 16, x1, y1, z1);
    }
    px[k] = x0 | (x1 << 16);
    py[k] = y0 | (y1 << 16);
    pz[k] = z0 | (z1 << 16);
  }
  x = make_uint4(px[0], px[1], px[2], px[3]);
  y = make_uint4(py[0], py[1], py[2], py[3]);
  z = make_uint4(pz[0], pz[1], pz[2], pz[3]);
}

// n pixels; the first nvec * 8 of them in 16-byte vectors (nvec is 0 when a
// pointer is not 16-byte aligned), the rest one at a time.
__global__ void __launch_bounds__(kThreads)
ycocgr_fwd_kernel(const uint16_t* __restrict__ r, const uint16_t* __restrict__ g,
                  const uint16_t* __restrict__ b, uint16_t* __restrict__ y,
                  uint16_t* __restrict__ co, uint16_t* __restrict__ cg, long long n,
                  long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 o0, o1, o2;
    vec8<false>(reinterpret_cast<const uint4*>(r)[i], reinterpret_cast<const uint4*>(g)[i],
                 reinterpret_cast<const uint4*>(b)[i], o0, o1, o2);
    reinterpret_cast<uint4*>(y)[i] = o0;
    reinterpret_cast<uint4*>(co)[i] = o1;
    reinterpret_cast<uint4*>(cg)[i] = o2;
  }
  for (long long i = nvec * 8 + tid; i < n; i += stride) {
    uint32_t o0, o1, o2;
    fwd_px(r[i], g[i], b[i], o0, o1, o2);
    y[i] = (uint16_t)o0;
    co[i] = (uint16_t)o1;
    cg[i] = (uint16_t)o2;
  }
}

__global__ void __launch_bounds__(kThreads)
ycocgr_inv_kernel(const uint16_t* __restrict__ y, const uint16_t* __restrict__ co,
                  const uint16_t* __restrict__ cg, uint16_t* __restrict__ r,
                  uint16_t* __restrict__ g, uint16_t* __restrict__ b, long long n,
                  long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 o0, o1, o2;
    vec8<true>(reinterpret_cast<const uint4*>(y)[i], reinterpret_cast<const uint4*>(co)[i],
                 reinterpret_cast<const uint4*>(cg)[i], o0, o1, o2);
    reinterpret_cast<uint4*>(r)[i] = o0;
    reinterpret_cast<uint4*>(g)[i] = o1;
    reinterpret_cast<uint4*>(b)[i] = o2;
  }
  for (long long i = nvec * 8 + tid; i < n; i += stride) {
    uint32_t o0, o1, o2;
    inv_px(y[i], co[i], cg[i], o0, o1, o2);
    r[i] = (uint16_t)o0;
    g[i] = (uint16_t)o1;
    b[i] = (uint16_t)o2;
  }
}

__device__ __forceinline__ int add_w(int a, int b) {  // a + b mod 2^32
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int sub_w(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// rows x n int32, one thread per (even, odd) pair: pairs = rows * ceil(n / 2).
__global__ void __launch_bounds__(kThreads)
wt53_fwd_kernel(const int* __restrict__ x, int* __restrict__ out, long long pairs, int n) {
  const int n_low = (n + 1) / 2, n_half = n / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    const long long row = p / n_low;
    const int i = (int)(p - row * n_low);
    const int* xr = x + row * n;
    // d[j] = odd[j] - ((even[j] + even_r[j]) >> 1), j < n_half
    auto d_at = [&](int j) {
      const int er = 2 * j + 2 < n ? xr[2 * j + 2] : xr[2 * j];
      return sub_w(xr[2 * j + 1], add_w(xr[2 * j], er) >> 1);
    };
    const int dr = d_at(min(i, n_half - 1));
    const int dl = i > 0 ? d_at(i - 1) : d_at(0);
    int* o = out + row * n;
    o[2 * i] = add_w(xr[2 * i], add_w(add_w(dl, dr), 2) >> 2);
    if (i < n_half) o[2 * i + 1] = dr;
  }
}

__global__ void __launch_bounds__(kThreads)
wt53_inv_kernel(const int* __restrict__ x, int* __restrict__ out, long long pairs, int n) {
  const int n_low = (n + 1) / 2, n_half = n / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    const long long row = p / n_low;
    const int i = (int)(p - row * n_low);
    const int* xr = x + row * n;
    // even[k] = s[k] - ((d[max(k-1,0)] + d[min(k,n_half-1)] + 2) >> 2), k < n_low
    auto even_at = [&](int k) {
      const int dl = xr[2 * max(k - 1, 0) + 1], dr = xr[2 * min(k, n_half - 1) + 1];
      return sub_w(xr[2 * k], add_w(add_w(dl, dr), 2) >> 2);
    };
    const int e = even_at(i);
    int* o = out + row * n;
    o[2 * i] = e;
    if (i < n_half) {
      const int er = 2 * i + 2 < n ? even_at(i + 1) : e;
      o[2 * i + 1] = add_w(xr[2 * i + 1], add_w(e, er) >> 1);
    }
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// n pixels of three u16 planes in (a0, a1, a2) and three out (o0, o1, o2);
// inverse != 0 selects the inverse transform.
int mic_ycocgr(const void* a0, const void* a1, const void* a2, void* o0, void* o1, void* o2,
               long long n, int inverse, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(a0) && aligned16(a1) && aligned16(a2) && aligned16(o0) &&
                   aligned16(o1) && aligned16(o2);
  const long long nvec = vec ? n / 8 : 0;
  const long long tail = n - nvec * 8;
  const int blocks = blocks_for(nvec > tail ? nvec : tail);
  cudaStream_t st = (cudaStream_t)stream;
  if (inverse)
    ycocgr_inv_kernel<<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)a0, (const uint16_t*)a1, (const uint16_t*)a2, (uint16_t*)o0,
        (uint16_t*)o1, (uint16_t*)o2, n, nvec);
  else
    ycocgr_fwd_kernel<<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)a0, (const uint16_t*)a1, (const uint16_t*)a2, (uint16_t*)o0,
        (uint16_t*)o1, (uint16_t*)o2, n, nvec);
  return (int)cudaGetLastError();
}

// rows x n int32 (n >= 2), contiguous, interleaved in and out.
int mic_wt53_rows(const void* x, void* out, long long rows, int n, int inverse, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  const long long pairs = rows * ((n + 1) / 2);
  const int blocks = blocks_for(pairs);
  cudaStream_t st = (cudaStream_t)stream;
  if (inverse)
    wt53_inv_kernel<<<blocks, kThreads, 0, st>>>((const int*)x, (int*)out, pairs, n);
  else
    wt53_fwd_kernel<<<blocks, kThreads, 0, st>>>((const int*)x, (int*)out, pairs, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
