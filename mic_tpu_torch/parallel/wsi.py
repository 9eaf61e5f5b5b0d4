"""MIC3 tiled whole-slide-image container with pyramid levels (reference
wsiformat.go), the parser: copies of ``mic_tpu.parallel.wsi``'s
``WSILevel``, ``WSIHeader``, ``read_mic3_header``, ``extract_tile_blob``,
``_bytes_per_pixel`` and ``_u16_to_bytes`` (pinned by
``tests/test_torch_ref_decode.py``).  Format (wsiformat.go:14-48)::

    HEADER (48B): "MIC3" | version u32 | width u32 | height u32
                  tileW u32 | tileH u32 | channels u16 | bps u8 | flags u8
                  levelCount u16 | 2 reserved | totalTiles u64 | 8 reserved
    LEVELS (20B each): width, height, tilesX, tilesY, firstTileIdx (u32)
    TILE TABLE (16B each): offset u64, length u64
    DATA: concatenated tile blobs
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["WSILevel", "WSIHeader", "read_mic3_header", "extract_tile_blob"]

MIC3_MAGIC = b"MIC3"
MIC3_VERSION = 1
MIC3_HEADER_SIZE = 48
MIC3_LEVEL_SIZE = 20
MIC3_TILE_ENT_SIZE = 16
FLAG_COLOR_TRANSFORM = 0x02


@dataclass
class WSILevel:
    width: int
    height: int
    tiles_x: int
    tiles_y: int
    first_tile_idx: int


@dataclass
class WSIHeader:
    width: int
    height: int
    tile_width: int
    tile_height: int
    channels: int
    bits_per_sample: int
    color_transform: bool
    levels: list[WSILevel] = field(default_factory=list)


def read_mic3_header(data: bytes):
    """Returns (header, tile_entries, data_offset)."""
    if len(data) < MIC3_HEADER_SIZE:
        raise ValueError("MIC3: file too small")
    if data[:4] != MIC3_MAGIC:
        raise ValueError(f"MIC3: invalid magic {data[:4]!r}")
    version, width, height, tile_w, tile_h = struct.unpack_from("<IIIII", data, 4)
    if version != MIC3_VERSION:
        raise ValueError(f"MIC3: unsupported version {version}")
    channels, bps, flags = struct.unpack_from("<HBB", data, 24)
    level_count, _ = struct.unpack_from("<HH", data, 28)
    total_tiles = struct.unpack_from("<Q", data, 32)[0]
    hdr = WSIHeader(width, height, tile_w, tile_h, channels, bps, bool(flags & FLAG_COLOR_TRANSFORM))
    pos = MIC3_HEADER_SIZE
    if len(data) < pos + level_count * MIC3_LEVEL_SIZE:
        raise ValueError("MIC3: truncated level descriptors")
    for _ in range(level_count):
        w, h, tx, ty, fidx = struct.unpack_from("<IIIII", data, pos)
        hdr.levels.append(WSILevel(w, h, tx, ty, fidx))
        pos += MIC3_LEVEL_SIZE
    if len(data) < pos + total_tiles * MIC3_TILE_ENT_SIZE:
        raise ValueError("MIC3: truncated tile offset table")
    entries = [struct.unpack_from("<QQ", data, pos + i * MIC3_TILE_ENT_SIZE) for i in range(total_tiles)]
    data_offset = pos + total_tiles * MIC3_TILE_ENT_SIZE
    return hdr, entries, data_offset


def extract_tile_blob(data: bytes, entries, data_offset: int, tile_idx: int) -> bytes:
    if tile_idx < 0 or tile_idx >= len(entries):
        raise ValueError(f"MIC3: tile index {tile_idx} out of range [0, {len(entries)})")
    off, ln = entries[tile_idx]
    start = data_offset + int(off)
    end = start + int(ln)
    if end > len(data):
        raise ValueError(f"MIC3: tile {tile_idx} data extends beyond file")
    return data[start:end]


def _bytes_per_pixel(channels: int, bps: int) -> int:
    return channels * (2 if bps == 16 else 1)


def _u16_to_bytes(data: np.ndarray, bps: int) -> bytes:
    if bps <= 8:
        return np.asarray(data, dtype=np.uint16).astype(np.uint8).tobytes()
    return np.asarray(data, dtype="<u2").tobytes()
