"""PICS, Parallel Image Compressed Strips (reference parallelstrips.go):
a copy of ``mic_tpu.parallel.strips`` (the decode side pinned by
``tests/test_torch_ref_decode.py`` and ``tests/test_torch_ingest.py``,
the writers by ``tests/test_torch_host_writers.py`` and
``tests/test_torch_native.py``).  Format::

    "PICS" | width u32 | height u32 | numStrips u32 | stripHeight u32
    offset table: numStrips x [offset u32, length u32]
    concatenated strip blobs

Each strip is an independent single-frame blob.  The 2-, 4- and 8-state
writers write the whole container on the C++ tier's ``std::thread`` pool
(``native.compress_strips_native``), as ``mic_tpu`` does with its
library built; where a strip is incompressible (``None``) the strips are
written in Python on a thread pool in strip order, as there.  The Python
reader decodes them on a thread pool.  ``tpu/ref_decode.py`` decodes the strips of
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
from ..native import compress_strips_native

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


def _strip_args(pixels, width, height, num_strips):
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != width * height:
        raise ValueError(
            f"parallelstrips: pixel count {len(pixels)} != width*height {width * height}"
        )
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    return pixels, max(1, min(num_strips, height))


def _compress_strips(pixels, width, height, max_value, num_strips, n_states) -> bytes:
    """The whole container on the C++ tier's thread pool; ``None`` (an
    incompressible strip) falls through to the Python assembly, as in
    mic_tpu."""
    pixels, num_strips = _strip_args(pixels, width, height, num_strips)
    blob = compress_strips_native(pixels, width, height, max_value, n_states=n_states,
                                  num_strips=num_strips)
    if blob is not None:
        return blob
    return _compress_strips_python(pixels, width, height, max_value, num_strips, n_states)


_FRAME_WRITERS = {2: compress_single_frame, 4: compress_single_frame_4state,
                  8: compress_single_frame_8state}


def _compress_strips_python(pixels, width, height, max_value, num_strips, n_states) -> bytes:
    """The numpy twin of the native container write, byte for byte: each
    strip's single-frame blob on a thread pool, in strip order."""
    pixels, num_strips = _strip_args(pixels, width, height, num_strips)
    frame_compress = _FRAME_WRITERS[n_states]
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
    return _compress_strips(pixels, width, height, max_value, num_strips, 2)


def compress_parallel_strips_4state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """4-state strips (parallelstrips.go:128)."""
    return _compress_strips(pixels, width, height, max_value, num_strips, 4)


def compress_parallel_strips_8state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """8-state strips (parallelstrips.go:199)."""
    return _compress_strips(pixels, width, height, max_value, num_strips, 8)


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
