"""RGB compression of the reference formats: YCoCg-R planes through the
Delta+RLE+FSE pipeline (the MICR payload and MIC3's RGB tiles).

A copy of ``mic_tpu.models.rgb`` (same names, same bytes; the plane
modes pinned by ``tests/test_torch_isolation.py``, the rest by
``tests/test_torch_host_writers.py``).  Blob layout (rgbcompress.go:18-24,
wsicompress.go:319-364)::

    [Y_len u32][Co_len u32][Cg_len u32][Y blob][Co blob][Cg blob]

where each plane blob is mode-prefixed (wsicompress.go:17-22):
0 = constant zero, 1 = constant value (u16 follows), 2 = compressed
(CompressSingleFrame stream), 3 = raw u16 fallback.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.color import ycocgr_forward, ycocgr_inverse
from ..ops.fse import IncompressibleError, UseRLEError
from .single_frame import compress_single_frame, decompress_single_frame

__all__ = [
    "compress_rgb",
    "decompress_rgb",
    "compress_rgb_tile_blob",
    "decompress_rgb_tile_blob",
    "compress_wsi_plane",
    "decompress_wsi_plane",
    "PLANE_CONSTANT_ZERO",
    "PLANE_CONSTANT",
    "PLANE_COMPRESSED",
    "PLANE_RAW",
]

PLANE_CONSTANT_ZERO = 0
PLANE_CONSTANT = 1
PLANE_COMPRESSED = 2
PLANE_RAW = 3


def compress_wsi_plane(plane: np.ndarray, width: int, height: int) -> bytes:
    """Single-plane compression with constant-plane short-circuit and raw
    fallback (wsicompress.go:373-421)."""
    plane = np.asarray(plane, dtype=np.uint16)
    first = int(plane[0])
    max_val = int(plane.max())
    if np.all(plane == first):
        if first == 0:
            return bytes([PLANE_CONSTANT_ZERO])
        return bytes([PLANE_CONSTANT]) + struct.pack("<H", first)
    if max_val < 255:
        max_val = 255  # keep a reasonable RLE midCount (wsicompress.go:398-400)
    try:
        compressed = compress_single_frame(plane, width, height, max_val)
    except (UseRLEError, IncompressibleError, ValueError):
        return bytes([PLANE_RAW]) + plane.astype("<u2").tobytes()
    return bytes([PLANE_COMPRESSED]) + compressed


def decompress_wsi_plane(data: bytes, width: int, height: int, n: int) -> np.ndarray:
    if len(data) == 0:
        raise ValueError("empty plane data")
    mode = data[0]
    if mode == PLANE_CONSTANT_ZERO:
        return np.zeros(n, dtype=np.uint16)
    if mode == PLANE_CONSTANT:
        if len(data) < 3:
            raise ValueError("constant plane data truncated")
        val = struct.unpack_from("<H", data, 1)[0]
        return np.full(n, val, dtype=np.uint16)
    if mode == PLANE_COMPRESSED:
        return decompress_single_frame(data[1:], width, height)
    if mode == PLANE_RAW:
        if len(data) < 1 + n * 2:
            raise ValueError("raw plane data truncated")
        return np.frombuffer(data, dtype="<u2", count=n, offset=1).copy()
    raise ValueError(f"unknown plane mode {mode}")


def compress_rgb_tile_blob(rgb: np.ndarray, width: int, height: int, color_transform: bool) -> bytes:
    rgb = np.asarray(rgb, dtype=np.uint8)
    if color_transform:
        y, co, cg = ycocgr_forward(rgb, width, height)
    else:
        px = rgb.reshape(-1, 3)
        y, co, cg = (
            px[:, 0].astype(np.uint16),
            px[:, 1].astype(np.uint16),
            px[:, 2].astype(np.uint16),
        )
    y_blob = compress_wsi_plane(y, width, height)
    co_blob = compress_wsi_plane(co, width, height)
    cg_blob = compress_wsi_plane(cg, width, height)
    return (
        struct.pack("<III", len(y_blob), len(co_blob), len(cg_blob))
        + y_blob
        + co_blob
        + cg_blob
    )


def decompress_rgb_tile_blob(blob: bytes, width: int, height: int, color_transform: bool) -> np.ndarray:
    if len(blob) < 12:
        raise ValueError("RGB tile blob too small")
    y_len, co_len, cg_len = struct.unpack_from("<III", blob, 0)
    off = 12
    if off + y_len + co_len + cg_len > len(blob):
        raise ValueError("RGB tile blob truncated")
    n = width * height
    y = decompress_wsi_plane(blob[off : off + y_len], width, height, n)
    off += y_len
    co = decompress_wsi_plane(blob[off : off + co_len], width, height, n)
    off += co_len
    cg = decompress_wsi_plane(blob[off : off + cg_len], width, height, n)
    if color_transform:
        return ycocgr_inverse(y, co, cg, width, height)
    out = np.empty((n, 3), dtype=np.uint8)
    out[:, 0] = y.astype(np.uint8)
    out[:, 1] = co.astype(np.uint8)
    out[:, 2] = cg.astype(np.uint8)
    return out.ravel()


def compress_rgb(rgb, width, height) -> bytes:
    """Reference CompressRGB (rgbcompress.go:25) — MICR payload."""
    return compress_rgb_tile_blob(rgb, width, height, True)


def decompress_rgb(data: bytes, width, height) -> np.ndarray:
    """Reference DecompressRGB (rgbcompress.go:31)."""
    return decompress_rgb_tile_blob(data, width, height, True)
