"""Gap removal: collapse a sparse RLE alphabet to [0, numUsed) before FSE
(reference gapremovalcompressu16.go).

A numpy copy of ``mic_tpu.ops.gapremoval`` (same names, same bytes, same
errors; pinned by ``tests/test_torch_wavelet_huffman_gap.py``).  Three
expand-map encodings, smallest chosen automatically:
raw list (0x01), bitmap (0x02), delta-list with 0xFF escape (0x03);
mode 0x00 = no gap removal.  Applied only when ``numUsed < symLen/2`` and
``overhead*8 < eliminatedZeros`` (the zero-run coding in writeCount costs
~2 bits per eliminated zero; the 1/8 factor is the conservative gate).
"""

from __future__ import annotations

import numpy as np

from .deltarle import delta_rle_compress, delta_rle_decompress
from .fse import IncompressibleError, UseRLEError
from .fse_codec import fse_compress, fse_compress_2state, fse_decompress_auto

__all__ = [
    "compress_single_frame_gap_removal",
    "decompress_single_frame_gap_removal",
]

MODE_NONE = 0x00
MODE_RAW = 0x01
MODE_BITMAP = 0x02
MODE_DELTA = 0x03


def _compress_rle_with_fse(rle_data: np.ndarray) -> bytes:
    try:
        return fse_compress_2state(rle_data)
    except (IncompressibleError, UseRLEError, ValueError):
        return fse_compress(rle_data)


def _delta_map_size(expand_map: np.ndarray) -> int:
    if len(expand_map) == 0:
        return 4 + 1
    gaps = np.diff(expand_map.astype(np.int64)) - 1
    return 4 + int(np.where(gaps >= 255, 3, 1).sum()) + 1


def _build_delta_map(expand_map: np.ndarray) -> bytes:
    out = bytearray()
    n = len(expand_map)
    out += int(n).to_bytes(2, "little")
    if n == 0:
        return bytes(out)
    out += int(expand_map[0]).to_bytes(2, "little")
    for i in range(1, n):
        gap = int(expand_map[i]) - int(expand_map[i - 1]) - 1
        if gap >= 255:
            out.append(0xFF)
            out += gap.to_bytes(2, "little")
        else:
            out.append(gap)
    return bytes(out)


def compress_single_frame_gap_removal(pixels, width, height, max_value) -> bytes:
    """Reference CompressSingleFrameGapRemoval (gapremovalcompressu16.go:52)."""
    rle_out = delta_rle_compress(pixels, width, height, max_value)

    counts = np.bincount(rle_out)
    max_sym = len(counts) - 1
    sym_len = max_sym + 1
    expand_map = np.nonzero(counts)[0].astype(np.uint16)
    num_used = len(expand_map)
    eliminated_zeros = sym_len - num_used

    raw_size = 3 + num_used * 2
    bitmap_size = 3 + (max_sym + 8) // 8
    delta_size = _delta_map_size(expand_map)

    mode, overhead = MODE_RAW, raw_size
    if bitmap_size < overhead:
        mode, overhead = MODE_BITMAP, bitmap_size
    if delta_size < overhead:
        mode, overhead = MODE_DELTA, delta_size

    apply_gr = num_used > 1 and num_used < sym_len // 2 and overhead * 8 < eliminated_zeros

    if not apply_gr:
        fse_data = _compress_rle_with_fse(rle_out)
        return bytes([MODE_NONE]) + fse_data

    compact_idx = np.zeros(sym_len, dtype=np.uint16)
    compact_idx[expand_map] = np.arange(num_used, dtype=np.uint16)
    remapped = compact_idx[rle_out]

    fse_data = _compress_rle_with_fse(remapped)

    if mode == MODE_RAW:
        hdr = bytes([MODE_RAW]) + int(num_used).to_bytes(2, "little") + expand_map.astype("<u2").tobytes()
    elif mode == MODE_BITMAP:
        bitmap = np.zeros((max_sym + 8) // 8, dtype=np.uint8)
        np.bitwise_or.at(bitmap, expand_map // 8, (1 << (expand_map % 8)).astype(np.uint8))
        hdr = bytes([MODE_BITMAP]) + int(max_sym).to_bytes(2, "little") + bitmap.tobytes()
    else:
        hdr = bytes([MODE_DELTA]) + _build_delta_map(expand_map)
    return hdr + fse_data


def decompress_single_frame_gap_removal(blob: bytes, width, height) -> np.ndarray:
    """Reference DecompressSingleFrameGapRemoval (gapremovalcompressu16.go:178)."""
    if len(blob) < 1:
        raise ValueError("gap removal: empty input")
    mode = blob[0]
    if mode == MODE_NONE:
        from ..models.single_frame import decompress_single_frame

        return decompress_single_frame(blob[1:], width, height)

    if mode == MODE_RAW:
        num = int.from_bytes(blob[1:3], "little")
        hdr = 3 + num * 2
        expand_map = np.frombuffer(blob[3:hdr], dtype="<u2")
        body = blob[hdr:]
    elif mode == MODE_BITMAP:
        max_sym = int.from_bytes(blob[1:3], "little")
        blen = (max_sym + 8) // 8
        bitmap = np.frombuffer(blob[3 : 3 + blen], dtype=np.uint8)
        bits = np.unpackbits(bitmap, bitorder="little")[: max_sym + 1]
        expand_map = np.nonzero(bits)[0].astype(np.uint16)
        body = blob[3 + blen :]
    elif mode == MODE_DELTA:
        num = int.from_bytes(blob[1:3], "little")
        expand_map = np.zeros(num, dtype=np.uint16)
        p = 5
        if num > 0:
            expand_map[0] = int.from_bytes(blob[3:5], "little")
            for i in range(1, num):
                b = blob[p]
                p += 1
                if b == 0xFF:
                    gap = int.from_bytes(blob[p : p + 2], "little")
                    p += 2
                else:
                    gap = b
                expand_map[i] = expand_map[i - 1] + gap + 1
        else:
            p = 5
        body = blob[p:]
    else:
        raise ValueError(f"gap removal: unknown mode byte {mode:#04x}")

    compact = fse_decompress_auto(body)
    if compact.size and int(compact.max()) >= len(expand_map):
        raise ValueError("gap removal: compact symbol out of range")
    rle_symbols = expand_map[compact]
    return delta_rle_decompress(rle_symbols, width, height)
