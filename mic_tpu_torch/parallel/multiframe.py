"""MIC2 multi-frame container (reference multiframe.go), the parser:
copies of ``mic_tpu.parallel.multiframe``'s ``MIC2Header``,
``read_mic2_header`` and ``extract_frame`` (pinned by
``tests/test_torch_ref_decode.py``).  Format (multiframe.go:14-32)::

    "MIC2" | width u32 | height u32 | frameCount u32
    flags u8 (bit0 = spatial, always set; bit1 = temporal) | 3 reserved
    frame table: N x [offset u32, length u32]
    concatenated frame blobs
"""

from __future__ import annotations

import struct

__all__ = ["MIC2Header", "read_mic2_header", "extract_frame"]

MIC2_MAGIC = b"MIC2"
MIC2_HEADER_SIZE = 20
MIC2_ENTRY_SIZE = 8
PIPELINE_TEMPORAL = 0x02


class MIC2Header:
    def __init__(self, width: int, height: int, frame_count: int, temporal: bool):
        self.width = width
        self.height = height
        self.frame_count = frame_count
        self.temporal = temporal


def read_mic2_header(data: bytes):
    """Returns (header, entries, data_offset)."""
    if len(data) < MIC2_HEADER_SIZE:
        raise ValueError("MIC2: file too small")
    if data[:4] != MIC2_MAGIC:
        raise ValueError(f"MIC2: invalid magic {data[:4]!r}")
    width, height, frame_count = struct.unpack_from("<III", data, 4)
    temporal = bool(data[16] & PIPELINE_TEMPORAL)
    hdr = MIC2Header(width, height, frame_count, temporal)
    table_size = frame_count * MIC2_ENTRY_SIZE
    data_offset = MIC2_HEADER_SIZE + table_size
    if len(data) < data_offset:
        raise ValueError("MIC2: file truncated in frame table")
    entries = [
        struct.unpack_from("<II", data, MIC2_HEADER_SIZE + i * MIC2_ENTRY_SIZE)
        for i in range(frame_count)
    ]
    return hdr, entries, data_offset


def extract_frame(data: bytes, entries, data_offset: int, frame_idx: int) -> bytes:
    if frame_idx < 0 or frame_idx >= len(entries):
        raise ValueError(f"MIC2: frame index {frame_idx} out of range [0, {len(entries)})")
    off, ln = entries[frame_idx]
    start = data_offset + off
    end = start + ln
    if end > len(data):
        raise ValueError(f"MIC2: frame {frame_idx} data extends beyond file")
    return data[start:end]
