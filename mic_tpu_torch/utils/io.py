"""MIC1 / MICR single-frame file containers and the raw binary loader
(reference cmd/mic-compress/main.go:26-91): a copy of
``mic_tpu.utils.io`` (``read_mic1`` pinned by
``tests/test_torch_ref_decode.py``, the rest by
``tests/test_torch_host_writers.py``).

    "MIC1" | width u32 | height u32 | pipeline u32 (=1) | len u32 | data
    "MICR" | width u32 | height u32 | CompressRGB blob
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_mic1", "read_mic1", "write_micr", "read_micr", "read_binary_image"]

MIC1_MAGIC = b"MIC1"
MICR_MAGIC = b"MICR"
PIPELINE_DELTA_RLE_FSE = 1


def write_mic1(width: int, height: int, compressed: bytes) -> bytes:
    """MIC1: magic | width u32 | height u32 | pipeline u32 (=1) | len u32 | data."""
    return (
        MIC1_MAGIC
        + struct.pack("<IIII", width, height, PIPELINE_DELTA_RLE_FSE, len(compressed))
        + compressed
    )


def read_mic1(data: bytes):
    """Returns (width, height, pipeline, payload)."""
    if len(data) < 20 or data[:4] != MIC1_MAGIC:
        raise ValueError("MIC1: invalid magic")
    width, height, pipeline, ln = struct.unpack_from("<IIII", data, 4)
    if 20 + ln > len(data):
        raise ValueError("MIC1: truncated")
    return width, height, pipeline, data[20 : 20 + ln]


def write_micr(width: int, height: int, blob: bytes) -> bytes:
    """MICR: magic | width u32 | height u32 | CompressRGB blob."""
    return MICR_MAGIC + struct.pack("<II", width, height) + blob


def read_micr(data: bytes):
    """Returns (width, height, payload)."""
    if len(data) < 12 or data[:4] != MICR_MAGIC:
        raise ValueError("MICR: invalid magic")
    width, height = struct.unpack_from("<II", data, 4)
    return width, height, data[12:]


def read_binary_image(path: str, cols: int, rows: int):
    """Raw little-endian uint16 image (reference ReadBinaryFile).
    Returns (pixels, max_value)."""
    px = np.fromfile(path, dtype="<u2", count=cols * rows)
    return px, int(px.max()) if px.size else 0
