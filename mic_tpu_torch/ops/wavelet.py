"""Le Gall 5/3 integer lifting wavelet (JPEG 2000 reversible), host tier.

A numpy copy of ``mic_tpu.ops.wavelet`` (same names, same arrays;
pinned by ``tests/test_torch_wavelet_huffman_gap.py``).  The device lift
is ``tpu/kernels.py`` (``wt53_rows_forward`` / ``_inverse``, the CUDA
kernels of ``csrc/transforms.cu``, and
``wavelet_{forward,inverse}_2d_separated``), held against
``wt53_forward_2d_separated`` here by ``chip_smoke.py``.

Lifting scheme (waveletu16.go:9-18)::

    Forward:  d[n] = x[2n+1] - floor((x[2n] + x[2n+2]) / 2)      (predict)
              s[n] = x[2n]   + floor((d[n-1] + d[n] + 2) / 4)    (update)
    Inverse:  reverse order, signs flipped.

Symmetric boundary extension; int64 workspace here (int32 in the
reference).  Two 2D layouts are supported, as in the reference:

* *interleaved* (even=low, odd=high in place) — WaveletForward2D,
  used by the V1 pipelines (waveletu16.go:126-148).
* *separated* (Mallat subband layout ``[LL|HL; LH|HH]``) — required for
  correct multi-level transforms (waveletu16.go:162-257).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "wt53_forward_1d",
    "wt53_inverse_1d",
    "wavelet_forward_2d",
    "wavelet_inverse_2d",
    "wt53_forward_2d_separated",
    "wt53_inverse_2d_separated",
    "collect_subband_order",
    "scatter_subband_order",
    "coeffs_to_u16",
    "u16_to_coeffs",
    "WAVELET_ESCAPE",
]

WAVELET_ESCAPE = np.uint16(65535)  # waveletfsecompressu16.go:18
WAVELET_ZZ_LIMIT = 32767


def _predict_fwd(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split x (length n >= 2 along axis -1) into (s, d) lifting halves.

    d[i] = x[2i+1] - floor((x[2i] + right_i)/2), right_i = x[2i+2] or
    symmetric extension x[2i] at the right edge (waveletu16.go:33-47).
    s[i] = x[2i] + floor((d[i-1] + d[i] + 2)/4) with d[-1] = d[0] and, for
    odd n, the last even using d[i-1] on both sides (waveletu16.go:50-73).
    """
    n = x.shape[-1]
    even = x[..., 0::2].astype(np.int64)  # length n_low
    odd = x[..., 1::2].astype(np.int64)  # length n_half
    n_half = n // 2
    n_low = (n + 1) // 2
    if n % 2 == 1:
        right = even[..., 1:]  # even[i+1] always exists for i < n_half
    else:
        right = np.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    d = odd - ((even[..., :n_half] + right) >> 1)
    if n % 2 == 1:
        # Last even (i = n_low-1) has no d[i]; it uses d[i-1] twice.
        d_right = np.concatenate([d, d[..., -1:]], axis=-1)
    else:
        d_right = d
    d_left = np.concatenate([d_right[..., :1], d[..., : n_low - 1]], axis=-1)
    s = even + ((d_left + d_right + 2) >> 2)
    return s, d


def wt53_forward_1d(data: np.ndarray, axis: int = -1) -> np.ndarray:
    """Forward lifting along ``axis``; output interleaved in place
    (even slots = low band s, odd = high band d), matching
    wt53Forward1D (waveletu16.go:26-74)."""
    data = np.asarray(data, dtype=np.int64)
    x = np.moveaxis(data, axis, -1)
    n = x.shape[-1]
    if n < 2:
        return data.copy()
    s, d = _predict_fwd(x)
    out = np.empty_like(x)
    out[..., 0::2] = s
    out[..., 1::2] = d
    return np.moveaxis(out, -1, axis)


def wt53_inverse_1d(data: np.ndarray, axis: int = -1) -> np.ndarray:
    """Inverse of wt53_forward_1d (waveletu16.go:78-122)."""
    data = np.asarray(data, dtype=np.int64)
    x = np.moveaxis(data, axis, -1)
    n = x.shape[-1]
    if n < 2:
        return data.copy()
    s = x[..., 0::2].astype(np.int64)
    d = x[..., 1::2].astype(np.int64)
    n_half = n // 2
    n_low = (n + 1) // 2
    if n % 2 == 1:
        d_right = np.concatenate([d, d[..., -1:]], axis=-1)
    else:
        d_right = d
    d_left = np.concatenate([d_right[..., :1], d[..., : n_low - 1]], axis=-1)
    even = s - ((d_left + d_right + 2) >> 2)
    if n % 2 == 1:
        right = even[..., 1:]
    else:
        right = np.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    odd = d + ((even[..., :n_half] + right) >> 1)
    out = np.empty_like(x)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return np.moveaxis(out, -1, axis)


def wavelet_forward_2d(data: np.ndarray, rows: int, cols: int, stride: int | None = None) -> np.ndarray:
    """Single-level interleaved 2D forward transform on the top-left
    rows×cols region (waveletForward2DRegion, waveletfsecompressu16.go:167-176)."""
    stride = stride or cols
    buf = np.asarray(data, dtype=np.int64).reshape(-1, stride)
    region = buf[:rows, :cols]
    region[:] = wt53_forward_1d(region, axis=1)
    region[:] = wt53_forward_1d(region, axis=0)
    return buf.ravel()


def wavelet_inverse_2d(data: np.ndarray, rows: int, cols: int, stride: int | None = None) -> np.ndarray:
    stride = stride or cols
    buf = np.asarray(data, dtype=np.int64).reshape(-1, stride)
    region = buf[:rows, :cols]
    region[:] = wt53_inverse_1d(region, axis=0)
    region[:] = wt53_inverse_1d(region, axis=1)
    return buf.ravel()


def _deinterleave(a: np.ndarray, axis: int) -> np.ndarray:
    return np.concatenate([np.take(a, np.arange(0, a.shape[axis], 2), axis=axis),
                           np.take(a, np.arange(1, a.shape[axis], 2), axis=axis)], axis=axis)


def _reinterleave(a: np.ndarray, axis: int) -> np.ndarray:
    n = a.shape[axis]
    n_low = (n + 1) // 2
    out = np.empty_like(a)
    idx_even = np.arange(0, n, 2)
    idx_odd = np.arange(1, n, 2)
    sl = [slice(None)] * a.ndim
    sl[axis] = idx_even
    out[tuple(sl)] = np.take(a, np.arange(n_low), axis=axis)
    sl[axis] = idx_odd
    out[tuple(sl)] = np.take(a, np.arange(n_low, n), axis=axis)
    return out


def wt53_forward_2d_separated(buf: np.ndarray, rows: int, cols: int, full_cols: int) -> None:
    """Forward transform of the rows×cols region into Mallat layout, in a
    buffer with row stride full_cols (wt53Forward2DSeparated,
    waveletu16.go:162-209).  Modifies ``buf`` (int64 2D view) in place."""
    view = buf.reshape(-1, full_cols)
    region = view[:rows, :cols]
    region[:] = _deinterleave(wt53_forward_1d(region, axis=1), axis=1)
    region[:] = _deinterleave(wt53_forward_1d(region, axis=0), axis=0)


def wt53_inverse_2d_separated(buf: np.ndarray, rows: int, cols: int, full_cols: int) -> None:
    """Inverse of wt53_forward_2d_separated (waveletu16.go:213-257)."""
    view = buf.reshape(-1, full_cols)
    region = view[:rows, :cols]
    region[:] = wt53_inverse_1d(_reinterleave(region, axis=0), axis=0)
    region[:] = wt53_inverse_1d(_reinterleave(region, axis=1), axis=1)


def _subband_dims(rows: int, cols: int, levels: int):
    n_r = [rows]
    n_c = [cols]
    for _ in range(levels):
        n_r.append((n_r[-1] + 1) // 2)
        n_c.append((n_c[-1] + 1) // 2)
    return n_r, n_c


def collect_subband_order(data: np.ndarray, rows: int, cols: int, full_cols: int, levels: int) -> np.ndarray:
    """Flatten a Mallat-layout buffer in subband-scan order: LL coarsest,
    then HL/LH/HH per level coarsest→finest (waveletfsecompressu16.go:202-241).
    Groups near-zero detail coefficients for better RLE."""
    view = np.asarray(data).reshape(-1, full_cols)
    n_r, n_c = _subband_dims(rows, cols, levels)
    parts = [view[: n_r[levels], : n_c[levels]].ravel()]
    for l in range(levels, 0, -1):
        parts.append(view[: n_r[l], n_c[l] : n_c[l - 1]].ravel())  # HL
        parts.append(view[n_r[l] : n_r[l - 1], : n_c[l]].ravel())  # LH
        parts.append(view[n_r[l] : n_r[l - 1], n_c[l] : n_c[l - 1]].ravel())  # HH
    return np.concatenate(parts)


def scatter_subband_order(linear: np.ndarray, rows: int, cols: int, full_cols: int, levels: int) -> np.ndarray:
    """Inverse of collect_subband_order (waveletfsecompressu16.go:245-282)."""
    out = np.zeros((rows, full_cols), dtype=np.int64)
    n_r, n_c = _subband_dims(rows, cols, levels)
    pos = 0

    def take(n):
        nonlocal pos
        v = linear[pos : pos + n]
        pos += n
        return v

    out[: n_r[levels], : n_c[levels]] = take(n_r[levels] * n_c[levels]).reshape(
        n_r[levels], n_c[levels]
    )
    for l in range(levels, 0, -1):
        h, w = n_r[l], n_c[l - 1] - n_c[l]
        out[: n_r[l], n_c[l] : n_c[l - 1]] = take(h * w).reshape(h, w)
        h, w = n_r[l - 1] - n_r[l], n_c[l]
        out[n_r[l] : n_r[l - 1], : n_c[l]] = take(h * w).reshape(h, w)
        h, w = n_r[l - 1] - n_r[l], n_c[l - 1] - n_c[l]
        out[n_r[l] : n_r[l - 1], n_c[l] : n_c[l - 1]] = take(h * w).reshape(h, w)
    return out.ravel()


def coeffs_to_u16(coeffs: np.ndarray) -> np.ndarray:
    """int32 coefficients → uint16 stream: ZigZag in [-32767, 32767], else
    escape [65535, hi16, lo16] (waveletfsecompressu16.go:28-40)."""
    c = np.asarray(coeffs, dtype=np.int64)
    small = (c >= -WAVELET_ZZ_LIMIT) & (c <= WAVELET_ZZ_LIMIT)
    zz = (((c >> 63) ^ (c << 1)) & 0xFFFF).astype(np.uint16)
    sizes = np.where(small, 1, 3).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    out = np.empty(int(sizes.sum()), dtype=np.uint16)
    out[starts] = np.where(small, zz, WAVELET_ESCAPE)
    esc = starts[~small]
    u = c[~small].astype(np.int64) & 0xFFFFFFFF
    out[esc + 1] = (u >> 16).astype(np.uint16)
    out[esc + 2] = (u & 0xFFFF).astype(np.uint16)
    return out


def u16_to_coeffs(stream: np.ndarray, n: int) -> np.ndarray:
    """Inverse of coeffs_to_u16 (waveletfsecompressu16.go:43-58).

    Escape markers cannot be confused with data: zigzag(32767)=65534 is
    the largest non-escape symbol, so every 65535 at a token boundary
    starts an escape triple.
    """
    s = np.asarray(stream, dtype=np.uint16)
    # Token walk is data-dependent but escapes are unambiguous: a position
    # is a token start iff it's not inside a previous escape triple.
    # Vectorized: iterate over escape positions (rare) — but an escape's
    # payload could itself contain 65535 words, so walk escape regions.
    out = np.empty(n, dtype=np.int64)
    is_esc = s == 65535
    if not is_esc.any():
        v = s[:n].astype(np.int64)
        return (v >> 1) ^ -(v & 1)
    i = 0
    count = 0
    esc_positions = np.nonzero(is_esc)[0]
    # Fast path between escapes: copy spans in bulk.
    ep = 0
    while count < n and i < len(s):
        # next escape at or after i that is a real token start
        while ep < len(esc_positions) and esc_positions[ep] < i:
            ep += 1
        nxt = esc_positions[ep] if ep < len(esc_positions) else len(s)
        span = min(nxt - i, n - count)
        if span > 0:
            v = s[i : i + span].astype(np.int64)
            out[count : count + span] = (v >> 1) ^ -(v & 1)
            count += span
            i += span
        if count < n and i < len(s) and s[i] == 65535:
            val = (int(s[i + 1]) << 16) | int(s[i + 2])
            if val >= 1 << 31:
                val -= 1 << 32
            out[count] = val
            count += 1
            i += 3
    if count < n:
        out[count:] = 0
    return out
