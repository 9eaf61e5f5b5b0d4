"""PICS, Parallel Image Compressed Strips (reference parallelstrips.go):
a copy of ``mic_tpu.parallel.strips`` without its native whole-container
branch, which writes the same bytes (the decode side pinned by
``tests/test_torch_ref_decode.py`` and ``tests/test_torch_ingest.py``,
the writers by ``tests/test_torch_host_writers.py``).  Format::

    "PICS" | width u32 | height u32 | numStrips u32 | stripHeight u32
    offset table: numStrips x [offset u32, length u32]
    concatenated strip blobs

Each strip is an independent single-frame blob, written and read on a
thread pool in strip order.  ``tpu/ref_decode.py`` decodes the strips of
many containers as one device entropy batch.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models.single_frame import (
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    decompress_single_frame,
)

__all__ = [
    "PICS_MAGIC",
    "compress_parallel_strips",
    "compress_parallel_strips_4state",
    "compress_parallel_strips_8state",
    "pics_strip_blobs",
    "decompress_parallel_strips",
]

PICS_MAGIC = b"PICS"
PICS_HEADER_BASE = 20


def _strip_plan(height: int, num_strips: int) -> tuple[int, int]:
    strip_h = (height + num_strips - 1) // num_strips
    actual = (height + strip_h - 1) // strip_h
    return strip_h, actual


def _compress_strips(pixels, width, height, max_value, num_strips, frame_compress) -> bytes:
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != width * height:
        raise ValueError(
            f"parallelstrips: pixel count {len(pixels)} != width*height {width * height}"
        )
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    num_strips = max(1, min(num_strips, height))
    strip_h, actual = _strip_plan(height, num_strips)

    def one(idx: int) -> bytes:
        y0 = idx * strip_h
        y1 = min(y0 + strip_h, height)
        return frame_compress(pixels[y0 * width : y1 * width], width, y1 - y0, max_value)

    with ThreadPoolExecutor(max_workers=min(actual, os.cpu_count() or 1)) as ex:
        results = list(ex.map(one, range(actual)))

    header = bytearray()
    header += PICS_MAGIC
    header += struct.pack("<IIII", width, height, actual, strip_h)
    offset = 0
    for r in results:
        header += struct.pack("<II", offset, len(r))
        offset += len(r)
    return bytes(header) + b"".join(results)


def compress_parallel_strips(pixels, width, height, max_value, num_strips=0) -> bytes:
    """2-state strips (reference CompressParallelStrips, parallelstrips.go:55)."""
    return _compress_strips(pixels, width, height, max_value, num_strips, compress_single_frame)


def compress_parallel_strips_4state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """4-state strips (parallelstrips.go:128)."""
    return _compress_strips(pixels, width, height, max_value, num_strips,
                            compress_single_frame_4state)


def compress_parallel_strips_8state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """8-state strips (parallelstrips.go:199)."""
    return _compress_strips(pixels, width, height, max_value, num_strips,
                            compress_single_frame_8state)


def pics_strip_blobs(blob: bytes):
    """Parse a PICS container into (width, height, strip_h, [(y0, h, bytes)])."""
    if len(blob) < PICS_HEADER_BASE or blob[:4] != PICS_MAGIC:
        raise ValueError("parallelstrips: invalid magic")
    width, height, num_strips, strip_h = struct.unpack_from("<IIII", blob, 4)
    header_size = PICS_HEADER_BASE + num_strips * 8
    if len(blob) < header_size:
        raise ValueError("parallelstrips: truncated header")
    if width <= 0 or height <= 0 or num_strips <= 0 or strip_h <= 0:
        raise ValueError("parallelstrips: invalid dimensions")
    strips = []
    for s in range(num_strips):
        off, ln = struct.unpack_from("<II", blob, PICS_HEADER_BASE + s * 8)
        start = header_size + off
        end = start + ln
        if start < 0 or end > len(blob) or start > end:
            raise ValueError(f"strip {s}: offset out of bounds")
        y0 = s * strip_h
        y1 = min(y0 + strip_h, height)
        strips.append((y0, y1 - y0, blob[start:end]))
    return width, height, strip_h, strips


def decompress_parallel_strips(blob: bytes):
    """Reference DecompressParallelStrips (parallelstrips.go:270), strips
    on a thread pool.  Returns (pixels, width, height)."""
    width, height, _strip_h, strips = pics_strip_blobs(blob)
    out = np.empty(width * height, dtype=np.uint16)

    def one(item):
        y0, sh, data = item
        out[y0 * width : (y0 + sh) * width] = decompress_single_frame(data, width, sh)

    with ThreadPoolExecutor(max_workers=min(len(strips), os.cpu_count() or 1)) as ex:
        list(ex.map(one, strips))
    return out, width, height
