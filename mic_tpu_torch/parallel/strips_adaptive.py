"""PICA, Parallel Image Compressed Adaptive strips (reference
parallelstripsadaptive.go): a copy of ``mic_tpu.parallel.strips_adaptive``
(same names, same bytes; pinned by ``tests/test_torch_host_writers.py``).

Extends PICS with (1) per-strip predictor selection — each strip tries
both avg and gradient predictors, keeping the smaller blob (flags bit 0),
and (2) content-adaptive boundaries via equal-cost partitioning on
inter-row absolute-delta mass with binary search.  Strips are written
and read on a thread pool, assembled in strip order.

Format::

    "PICA" | width u32 | height u32 | numStrips u32
    entries: numStrips x [y0 u32, offset u32, length u32, flags u32]
    concatenated strip blobs
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models.single_frame import (
    compress_single_frame,
    compress_single_frame_grad,
    decompress_single_frame,
    decompress_single_frame_grad,
)

__all__ = [
    "compress_parallel_strips_adaptive",
    "decompress_parallel_strips_adaptive",
    "adaptive_strip_boundaries",
]

PICA_MAGIC = b"PICA"
PICA_HDR_SIZE = 16
PICA_ENTRY_SIZE = 16
FLAG_GRAD_PREDICTOR = 1 << 0


def adaptive_strip_boundaries(pixels, width, height, num_strips) -> list[int]:
    """Equal-cost strip start rows on cumulative inter-row |delta| mass
    (parallelstripsadaptive.go:227-289)."""
    if num_strips >= height:
        return list(range(height))
    if num_strips == 1:
        return [0]
    img = np.asarray(pixels, dtype=np.int64).reshape(height, width)
    row_cost = np.zeros(height, dtype=np.float64)
    row_cost[1:] = np.abs(img[1:] - img[:-1]).sum(axis=1)
    cum = np.concatenate(([0.0], np.cumsum(row_cost)))
    total = cum[-1]
    starts = [0]
    if total == 0:
        return [i * height // num_strips for i in range(num_strips)]
    for i in range(1, num_strips):
        target = total * i / num_strips
        lo, hi = starts[-1] + 1, height
        while lo < hi:
            mid = (lo + hi) >> 1
            if cum[mid] < target:
                lo = mid + 1
            else:
                hi = mid
        starts.append(min(lo, height - 1))
    return starts


def compress_parallel_strips_adaptive(pixels, width, height, max_value, num_strips=0) -> bytes:
    """Reference CompressParallelStripsAdaptive (parallelstripsadaptive.go:54)."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != width * height:
        raise ValueError(f"pica: pixel count {len(pixels)} != width*height {width * height}")
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    num_strips = max(1, min(num_strips, height))
    starts = adaptive_strip_boundaries(pixels, width, height, num_strips)
    actual = len(starts)

    def one(idx: int):
        y0 = starts[idx]
        y1 = starts[idx + 1] if idx + 1 < actual else height
        sh = y1 - y0
        strip = pixels[y0 * width : y1 * width]
        blob_avg = err_avg = None
        try:
            blob_avg = compress_single_frame(strip, width, sh, max_value)
        except Exception as e:  # noqa: BLE001 — mirror Go's err propagation
            err_avg = e
        try:
            blob_grad = compress_single_frame_grad(strip, width, sh, max_value)
        except Exception:
            blob_grad = None
        if blob_grad is not None and (blob_avg is None or len(blob_grad) <= len(blob_avg)):
            return blob_grad, FLAG_GRAD_PREDICTOR, None
        return blob_avg, 0, err_avg

    with ThreadPoolExecutor(max_workers=min(actual, os.cpu_count() or 1)) as ex:
        results = list(ex.map(one, range(actual)))
    for i, (_, _, err) in enumerate(results):
        if err is not None:
            raise RuntimeError(f"pica: strip {i}") from err

    header = bytearray()
    header += PICA_MAGIC
    header += struct.pack("<III", width, height, actual)
    offset = 0
    blobs = []
    for i, (blob, flags, _) in enumerate(results):
        header += struct.pack("<IIII", starts[i], offset, len(blob), flags)
        offset += len(blob)
        blobs.append(blob)
    return bytes(header) + b"".join(blobs)


def decompress_parallel_strips_adaptive(blob: bytes):
    """Reference DecompressParallelStripsAdaptive (parallelstripsadaptive.go:142).
    Returns (pixels, width, height)."""
    if len(blob) < PICA_HDR_SIZE or blob[:4] != PICA_MAGIC:
        raise ValueError("pica: invalid magic")
    width, height, num_strips = struct.unpack_from("<III", blob, 4)
    header_size = PICA_HDR_SIZE + num_strips * PICA_ENTRY_SIZE
    if len(blob) < header_size:
        raise ValueError("pica: truncated header")
    if width <= 0 or height <= 0 or num_strips <= 0:
        raise ValueError("pica: invalid dimensions")

    entries = []
    for i in range(num_strips):
        y0, off, ln, flags = struct.unpack_from("<IIII", blob, PICA_HDR_SIZE + i * PICA_ENTRY_SIZE)
        entries.append((y0, off, ln, flags))

    out = np.empty(width * height, dtype=np.uint16)

    def one(idx: int):
        y0, off, ln, flags = entries[idx]
        y1 = entries[idx + 1][0] if idx + 1 < num_strips else height
        sh = y1 - y0
        start = header_size + off
        end = start + ln
        if start < 0 or end > len(blob) or start > end:
            raise ValueError(f"strip {idx}: offset out of bounds")
        if flags & FLAG_GRAD_PREDICTOR:
            strip = decompress_single_frame_grad(blob[start:end], width, sh)
        else:
            strip = decompress_single_frame(blob[start:end], width, sh)
        out[y0 * width : y1 * width] = strip

    with ThreadPoolExecutor(max_workers=min(num_strips, os.cpu_count() or 1)) as ex:
        list(ex.map(one, range(num_strips)))
    return out, width, height
