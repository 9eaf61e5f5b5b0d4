"""MIC2 multi-frame container (reference multiframe.go +
multiframecompress.go): a copy of ``mic_tpu.parallel.multiframe``.  The
container code (``MIC2Header``, ``write_mic2``, ``read_mic2_header``,
``extract_frame``) is pinned by ``tests/test_torch_ref_decode.py`` and
``tests/test_torch_multiframe.py``; the host series
(``compress_multi_frame``, ``decompress_multi_frame``,
``decompress_frame``) by ``tests/test_torch_host_writers.py``; the
device-format series, whose frame payloads are MICW blobs
(``compress_multi_frame_device`` / ``decompress_multi_frame_device``),
takes an added ``device``, as do the host readers for a frame that is a
MICW blob.  Format (multiframe.go:14-32)::

    "MIC2" | width u32 | height u32 | frameCount u32
    flags u8 (bit0 = spatial, always set; bit1 = temporal) | 3 reserved
    frame table: N x [offset u32, length u32]
    concatenated frame blobs

Independent mode gives O(1) random frame access; temporal mode stores
ZigZag inter-frame residuals (frames 1..k need frames 0..k-1).
"""

from __future__ import annotations

import struct

import numpy as np

from ..models.single_frame import (
    compress_residual_frame,
    compress_single_frame,
    decompress_residual_frame,
    decompress_single_frame,
)
from ..ops.predictors import temporal_delta_decode, temporal_delta_encode

__all__ = [
    "MIC2Header",
    "write_mic2",
    "read_mic2_header",
    "extract_frame",
    "compress_multi_frame",
    "decompress_multi_frame",
    "decompress_frame",
    "compress_multi_frame_device",
    "decompress_multi_frame_device",
]

MIC2_MAGIC = b"MIC2"
MIC2_HEADER_SIZE = 20
MIC2_ENTRY_SIZE = 8
PIPELINE_SPATIAL = 0x01
PIPELINE_TEMPORAL = 0x02


class MIC2Header:
    def __init__(self, width: int, height: int, frame_count: int, temporal: bool):
        self.width = width
        self.height = height
        self.frame_count = frame_count
        self.temporal = temporal


def write_mic2(hdr: MIC2Header, frames: list[bytes]) -> bytes:
    if len(frames) != hdr.frame_count:
        raise ValueError(f"frame count mismatch: header={hdr.frame_count}, frames={len(frames)}")
    flags = PIPELINE_SPATIAL | (PIPELINE_TEMPORAL if hdr.temporal else 0)
    out = bytearray()
    out += MIC2_MAGIC
    out += struct.pack("<III", hdr.width, hdr.height, hdr.frame_count)
    out += bytes([flags, 0, 0, 0])
    offset = 0
    for f in frames:
        out += struct.pack("<II", offset, len(f))
        offset += len(f)
    for f in frames:
        out += f
    return bytes(out)


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


def compress_multi_frame(frames, width, height, max_value, temporal: bool) -> bytes:
    """Reference CompressMultiFrame (multiframecompress.go:179)."""
    if len(frames) == 0:
        raise ValueError("no frames to compress")
    blobs = []
    for i, frame in enumerate(frames):
        frame = np.asarray(frame, dtype=np.uint16)
        if temporal and i > 0:
            residuals = temporal_delta_encode(frame, np.asarray(frames[i - 1], dtype=np.uint16))
            res_max = int(residuals.max()) if residuals.size else 0
            blobs.append(compress_residual_frame(residuals, res_max))
        else:
            blobs.append(compress_single_frame(frame, width, height, max_value))
    return write_mic2(MIC2Header(width, height, len(frames), temporal), blobs)


def _micw_plane(blob: bytes, device):
    """A device-format frame payload (a MICW blob, as
    ``compress_multi_frame_device`` writes) decoded on ``device``."""
    import torch

    from ..tpu.strips import micw_decompress_device

    return np.asarray(micw_decompress_device(blob, torch.device(device))[0], dtype=np.uint16)


def decompress_multi_frame(data: bytes, device="cuda"):
    """Reference DecompressMultiFrame — returns (frames, header).  A frame
    stored as a MICW blob (device-format containers) decodes on
    ``device``; host frames decode with numpy."""
    hdr, entries, data_offset = read_mic2_header(data)
    frames = []
    prev = None
    for i in range(hdr.frame_count):
        blob = extract_frame(data, entries, data_offset, i)
        if hdr.temporal and i > 0:
            if blob[:4] == b"MICW":
                residuals = _micw_plane(blob, device)
            else:
                residuals = decompress_residual_frame(blob)
            pixels = temporal_delta_decode(residuals, prev)
        elif blob[:4] == b"MICW":
            pixels = _micw_plane(blob, device)
        else:
            pixels = decompress_single_frame(blob, hdr.width, hdr.height)
        frames.append(pixels)
        prev = pixels
    return frames, hdr


def decompress_frame(data: bytes, frame_idx: int, device="cuda"):
    """Reference DecompressFrame — O(1) in independent mode, sequential
    0..k in temporal mode.  Returns (pixels, header).  An independent
    frame stored as a MICW blob decodes on ``device``."""
    hdr, entries, data_offset = read_mic2_header(data)
    if frame_idx < 0 or frame_idx >= hdr.frame_count:
        raise ValueError(f"frame index {frame_idx} out of range [0, {hdr.frame_count})")
    if not hdr.temporal:
        blob = extract_frame(data, entries, data_offset, frame_idx)
        if blob[:4] == b"MICW":
            return _micw_plane(blob, device), hdr
        return decompress_single_frame(blob, hdr.width, hdr.height), hdr
    prev = None
    for i in range(frame_idx + 1):
        blob = extract_frame(data, entries, data_offset, i)
        if i > 0:
            residuals = decompress_residual_frame(blob)
            prev = temporal_delta_decode(residuals, prev)
        else:
            prev = decompress_single_frame(blob, hdr.width, hdr.height)
    return prev, hdr


def compress_multi_frame_device(frames, width, height, max_value, device, lanes: int = 128,
                                temporal: bool = False, entropy: str = "standard",
                                device_encode: bool = False) -> bytes:
    """MIC2 container whose frame payloads are MICW device-format blobs,
    the bytes ``mic_tpu.parallel.multiframe.compress_multi_frame_device``
    writes.

    Independent mode (default): O(1) random frame access, every frame's
    strips pool into the decode plan's launches.  Temporal mode mirrors
    the host MIC2 (multiframe*.go): frame i > 0 stores zigzag residuals
    against frame i-1; the residual planes still decode in one batch and
    only the final add chains across frames.

    With ``device_encode=True`` every frame's strips are encoded in one
    call on ``device``, the zzd pipeline (what ``mic_tpu``'s device encoder
    writes; ``lanes`` is not read, as there).  Otherwise the frames take
    the "auto-fast" trial set of ``mic_tpu``'s host ``micw_compress``: at
    128 lanes through the device encoder in one call on ``device`` (the
    same bytes), at any other ``lanes`` through the port's host copy of
    ``micw_compress``, frame by frame, as ``mic_tpu`` writes them."""
    from ..tpu.rans_encode import micw_compress_device_many
    from ..tpu.strips import micw_compress

    planes = []
    for i, f in enumerate(frames):
        f = np.asarray(f, dtype=np.uint16)
        if temporal and i > 0:
            plane = temporal_delta_encode(f, np.asarray(frames[i - 1], dtype=np.uint16))
            mv = max(int(plane.max()), 1)
        else:
            plane = f
            mv = max_value
        planes.append((plane, width, height, mv))
    if device_encode or lanes == 128:
        blobs = micw_compress_device_many(planes, device, entropy=entropy,
                                          predictor="zzd" if device_encode else "auto-fast")
    else:
        blobs = [micw_compress(p, w, h, mv, lanes=lanes, entropy=entropy)
                 for p, w, h, mv in planes]
    return write_mic2(MIC2Header(width, height, len(frames), temporal=temporal), blobs)


def decompress_multi_frame_device(data: bytes, device):
    """Batch-decode a device-format MIC2 on ``device``: every frame's
    strips (or residual-plane strips in temporal mode) pool into as few
    launches as possible; the temporal add chain is a numpy pass, as in
    ``mic_tpu``.  Returns (frames, header)."""
    from ..tpu.strips import micw_decode_many

    hdr, entries, data_offset = read_mic2_header(data)
    blobs = [extract_frame(data, entries, data_offset, i) for i in range(hdr.frame_count)]
    planes = [p for p, _w, _h in micw_decode_many(blobs, device)]
    if not hdr.temporal:
        return planes, hdr
    frames = [np.asarray(planes[0], dtype=np.uint16)]
    for i in range(1, hdr.frame_count):
        frames.append(temporal_delta_decode(np.asarray(planes[i], dtype=np.uint16), frames[-1]))
    return frames, hdr
