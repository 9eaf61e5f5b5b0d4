"""MIC1 single-frame file container (reference
cmd/mic-compress/main.go:26-91): a copy of ``mic_tpu.utils.io.read_mic1``
(pinned by ``tests/test_torch_ref_decode.py``).

    "MIC1" | width u32 | height u32 | pipeline u32 (=1) | len u32 | data
"""

from __future__ import annotations

import struct

__all__ = ["read_mic1"]

MIC1_MAGIC = b"MIC1"


def read_mic1(data: bytes):
    """Returns (width, height, pipeline, payload)."""
    if len(data) < 20 or data[:4] != MIC1_MAGIC:
        raise ValueError("MIC1: invalid magic")
    width, height, pipeline, ln = struct.unpack_from("<IIII", data, 4)
    if 20 + ln > len(data):
        raise ValueError("MIC1: truncated")
    return width, height, pipeline, data[20 : 20 + ln]
