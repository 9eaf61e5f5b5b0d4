"""Wavelet compression pipelines (reference waveletfsecompressu16.go).

A numpy copy of ``mic_tpu.models.wavelet_pipeline`` (same names, same
bytes; pinned by ``tests/test_torch_wavelet_huffman_gap.py``).  Three
stream-compatible variants:

* **V1** (WaveletFSE): interleaved layout, coeffs → ZigZag u16 → FSE-4.
  Header: rows u32 | cols u32 | maxValue u16 | levels u8 (11 bytes).
* **V1.5** (WaveletRLEFSE): interleaved layout + RLE before FSE-4.
  Header adds encodedLen u32 (15 bytes).
* **V2** (WaveletV2RLEFSE): separated Mallat layout, subband-scan order,
  RLE + FSE-4; 11-byte header.  The reference's "V2 SIMD" variant is
  bit-identical — here the vectorized transform *is* the only transform,
  so the SIMD entry points are aliases.

The transforms run on the host (``ops/wavelet.py``), as in ``mic_tpu``;
the device lift (``tpu/kernels.py``) computes the same coefficients.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.fse_codec import fse_compress_4state, fse_decompress_4state
from ..ops.rle import RleEncoder, rle_decompress
from ..ops.wavelet import (
    coeffs_to_u16,
    collect_subband_order,
    scatter_subband_order,
    u16_to_coeffs,
    wavelet_forward_2d,
    wavelet_inverse_2d,
    wt53_forward_2d_separated,
    wt53_inverse_2d_separated,
)

__all__ = [
    "wavelet_fse_compress",
    "wavelet_fse_decompress",
    "wavelet_rle_fse_compress",
    "wavelet_rle_fse_decompress",
    "wavelet_v2_rle_fse_compress",
    "wavelet_v2_rle_fse_decompress",
    "wavelet_v2_simd_rle_fse_compress",
    "wavelet_v2_simd_rle_fse_decompress",
]


def _level_dims(rows: int, cols: int, levels: int):
    dims = []
    r, c = rows, cols
    for _ in range(levels):
        dims.append((r, c))
        r, c = (r + 1) // 2, (c + 1) // 2
    return dims


def _apply_forward(data: np.ndarray, rows, cols, levels, separated: bool) -> int:
    """Multi-level forward transform; returns actual level count (auto-stops
    when a dimension drops below 2, waveletfsecompressu16.go:322-330)."""
    r, c = rows, cols
    actual = 0
    for _ in range(levels):
        if r < 2 or c < 2:
            break
        if separated:
            wt53_forward_2d_separated(data, r, c, cols)
        else:
            wavelet_forward_2d(data, r, c, cols)
        r, c = (r + 1) // 2, (c + 1) // 2
        actual += 1
    return actual


def _rle_encode_stream(encoded: np.ndarray) -> np.ndarray:
    """RLE with maxValue = (1 << bit_length(zzMax)) - 1 (waveletfse…go:339-352)."""
    zz_max = int(encoded.max()) if encoded.size else 0
    depth = max(zz_max.bit_length(), 1)
    rle_max = (1 << depth) - 1
    enc = RleEncoder(len(encoded), 1, rle_max)
    return enc.compress(encoded)


def wavelet_fse_compress(pixels, rows, cols, max_value, levels=4) -> bytes:
    """Reference WaveletFSECompressU16 (waveletfsecompressu16.go:71)."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != rows * cols:
        raise ValueError("pixel count does not match rows*cols")
    levels = min(max(levels, 1), 4)
    data = pixels.astype(np.int64)
    levels = _apply_forward(data, rows, cols, levels, separated=False)
    encoded = coeffs_to_u16(data)
    fse_out = fse_compress_4state(encoded)
    return struct.pack("<IIHB", rows, cols, max_value, levels) + fse_out


def wavelet_fse_decompress(blob: bytes):
    """Returns (pixels, rows, cols)."""
    if len(blob) < 11:
        raise ValueError("compressed data too short")
    rows, cols, _max_value, levels = struct.unpack_from("<IIHB", blob, 0)
    encoded = fse_decompress_4state(blob[11:])
    data = u16_to_coeffs(encoded, rows * cols)
    for r, c in reversed(_level_dims(rows, cols, levels)):
        wavelet_inverse_2d(data, r, c, cols)
    return (data & 0xFFFF).astype(np.uint16), rows, cols


def wavelet_rle_fse_compress(pixels, rows, cols, max_value, levels=4) -> bytes:
    """Reference WaveletRLEFSECompressU16 (waveletfsecompressu16.go:551)."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != rows * cols:
        raise ValueError("pixel count does not match rows*cols")
    levels = min(max(levels, 1), 4)
    data = pixels.astype(np.int64)
    levels = _apply_forward(data, rows, cols, levels, separated=False)
    encoded = coeffs_to_u16(data)
    rle_out = _rle_encode_stream(encoded)
    fse_out = fse_compress_4state(rle_out)
    return struct.pack("<IIHBI", rows, cols, max_value, levels, len(encoded)) + fse_out


def wavelet_rle_fse_decompress(blob: bytes):
    if len(blob) < 15:
        raise ValueError("compressed data too short")
    rows, cols, _mx, levels, _enc_len = struct.unpack_from("<IIHBI", blob, 0)
    rle_data = fse_decompress_4state(blob[15:])
    encoded = rle_decompress(rle_data)
    data = u16_to_coeffs(encoded, rows * cols)
    for r, c in reversed(_level_dims(rows, cols, levels)):
        wavelet_inverse_2d(data, r, c, cols)
    return (data & 0xFFFF).astype(np.uint16), rows, cols


def wavelet_v2_rle_fse_compress(pixels, rows, cols, max_value, levels=5) -> bytes:
    """Reference WaveletV2RLEFSECompressU16 (waveletfsecompressu16.go:303):
    Mallat layout + subband-scan order + RLE + FSE-4."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != rows * cols:
        raise ValueError("pixel count does not match rows*cols")
    levels = min(max(levels, 1), 8)
    data = pixels.astype(np.int64)
    levels = _apply_forward(data, rows, cols, levels, separated=True)
    ordered = collect_subband_order(data, rows, cols, cols, levels)
    encoded = coeffs_to_u16(ordered)
    rle_out = _rle_encode_stream(encoded)
    fse_out = fse_compress_4state(rle_out)
    return struct.pack("<IIHB", rows, cols, max_value, levels) + fse_out


def wavelet_v2_rle_fse_decompress(blob: bytes):
    if len(blob) < 11:
        raise ValueError("compressed data too short")
    rows, cols, _mx, levels = struct.unpack_from("<IIHB", blob, 0)
    rle_data = fse_decompress_4state(blob[11:])
    encoded = rle_decompress(rle_data)
    ordered = u16_to_coeffs(encoded, rows * cols)
    data = scatter_subband_order(ordered, rows, cols, cols, levels)
    for r, c in reversed(_level_dims(rows, cols, levels)):
        wt53_inverse_2d_separated(data, r, c, cols)
    return (data & 0xFFFF).astype(np.uint16), rows, cols


# The reference's SIMD variants produce bit-identical streams
# (waveletfsecompressu16.go:423-426); our host transform is already the
# vectorized form, so these are aliases kept for API parity.
wavelet_v2_simd_rle_fse_compress = wavelet_v2_rle_fse_compress
wavelet_v2_simd_rle_fse_decompress = wavelet_v2_rle_fse_decompress
