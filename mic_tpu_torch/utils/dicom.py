"""Minimal DICOM reader for uncompressed single/multi-frame pixel data:
a copy of ``mic_tpu.utils.dicom`` (same names, same arrays; pinned by
``tests/test_torch_dicom.py``), the CLI's ``-dicom`` entry.

Covers what the codec's ingest path needs (the reference uses
suyashkumar/dicom — cmd/mic-compress/main.go:106-313): part-10 files with
implicit/explicit VR, little or big endian, native (uncompressed)
PixelData, MONOCHROME or RGB.  This is not a general DICOM library.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["DicomImage", "read_dicom"]

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"UC", b"UR", b"OD", b"OL"}

# Tags we care about.
_TAG_ROWS = (0x0028, 0x0010)
_TAG_COLS = (0x0028, 0x0011)
_TAG_BITS_ALLOC = (0x0028, 0x0100)
_TAG_BITS_STORED = (0x0028, 0x0101)
_TAG_PIXEL_REP = (0x0028, 0x0103)
_TAG_SAMPLES = (0x0028, 0x0002)
_TAG_FRAMES = (0x0028, 0x0008)
_TAG_PLANAR = (0x0028, 0x0006)
_TAG_PHOTOMETRIC = (0x0028, 0x0004)
_TAG_PIXELDATA = (0x7FE0, 0x0010)
_TAG_TS = (0x0002, 0x0010)

_TS_IMPLICIT_LE = "1.2.840.10008.1.2"
_TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_TS_EXPLICIT_BE = "1.2.840.10008.1.2.2"


@dataclass
class DicomImage:
    rows: int
    cols: int
    frames: list[np.ndarray] = field(default_factory=list)  # each (rows*cols*samples,) uint16
    samples_per_pixel: int = 1
    bits_allocated: int = 16
    bits_stored: int = 16
    photometric: str = ""

    @property
    def pixels(self) -> np.ndarray:
        return self.frames[0]

    @property
    def max_value(self) -> int:
        return int(max(int(f.max()) for f in self.frames))


def _parse_elements(data: bytes, pos: int, explicit: bool, big: bool, stop_at_pixeldata=True):
    end = "<" if not big else ">"
    elements = {}
    n = len(data)
    while pos + 8 <= n:
        group, elem = struct.unpack_from(end + "HH", data, pos)
        pos += 4
        if explicit or group == 0x0002:
            vr = data[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from(end + "I", data, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from(end + "H", data, pos + 2)[0]
                pos += 4
        else:
            vr = b""
            length = struct.unpack_from(end + "I", data, pos)[0]
            pos += 4
        tag = (group, elem)
        if tag == _TAG_PIXELDATA:
            if length == 0xFFFFFFFF:
                raise ValueError("encapsulated (compressed) PixelData not supported")
            elements[tag] = data[pos : pos + length]
            pos += length
            if stop_at_pixeldata:
                break
            continue
        if length == 0xFFFFFFFF or vr == b"SQ":
            # Skip sequences: parse items until sequence delimiter.
            pos = _skip_sequence(data, pos, end, length)
            continue
        elements[tag] = data[pos : pos + length]
        pos += length
    return elements


def _skip_sequence(data: bytes, pos: int, end: str, length: int) -> int:
    if length != 0xFFFFFFFF:
        return pos + length
    while pos + 8 <= len(data):
        group, elem, ln = struct.unpack_from(end + "HHI", data, pos)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return pos
        if (group, elem) == (0xFFFE, 0xE000):  # item
            if ln == 0xFFFFFFFF:
                # undefined-length item: scan for item delimiter
                while pos + 8 <= len(data):
                    g2, e2, l2 = struct.unpack_from(end + "HHI", data, pos)
                    pos += 8
                    if (g2, e2) == (0xFFFE, 0xE00D):
                        break
                    pos += l2
            else:
                pos += ln
    return pos


def _us(elements, tag, end, default=None):
    v = elements.get(tag)
    if v is None or len(v) < 2:
        return default
    return struct.unpack(end + "H", v[:2])[0]


def _intstr(elements, tag, default=None):
    v = elements.get(tag)
    if v is None:
        return default
    try:
        return int(v.decode("ascii", "ignore").strip("\x00 "))
    except ValueError:
        return default


def read_dicom(path_or_bytes) -> DicomImage:
    """Parse a DICOM file and return native uint16 frames.

    Signed (PixelRepresentation=1) data is reinterpreted as its unsigned
    two's-complement bits, matching the reference ingest which copies
    native frame samples straight into uint16.
    """
    if isinstance(path_or_bytes, (str, bytes)) and not (
        isinstance(path_or_bytes, bytes) and len(path_or_bytes) > 256
    ):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes

    if len(data) > 132 and data[128:132] == b"DICM":
        pos = 132
        # mic_tpu parses the whole file as explicit VR here and drops the
        # result; the call stays so that a malformed file raises as it does there.
        _parse_elements(data, pos, explicit=True, big=False, stop_at_pixeldata=False)
        # Parse group 2 only to find the transfer syntax and the body's start.
        pos = 132
        end = "<"
        ts = _TS_EXPLICIT_LE
        # walk group-2 elements
        while pos + 8 <= len(data):
            group, elem = struct.unpack_from("<HH", data, pos)
            if group != 0x0002:
                break
            vr = data[pos + 4 : pos + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", data, pos + 6 + 2)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", data, pos + 6)[0]
                hdr = 8
            if (group, elem) == _TAG_TS:
                ts = data[pos + hdr : pos + hdr + length].decode("ascii").strip("\x00 ")
            pos += hdr + length
        body_start = pos
    else:
        body_start = 0
        ts = _TS_IMPLICIT_LE

    big = ts == _TS_EXPLICIT_BE
    explicit = ts != _TS_IMPLICIT_LE
    end = ">" if big else "<"
    elements = _parse_elements(data, body_start, explicit=explicit, big=big)

    rows = _us(elements, _TAG_ROWS, end)
    cols = _us(elements, _TAG_COLS, end)
    if rows is None or cols is None:
        raise ValueError("DICOM: missing Rows/Columns")
    samples = _us(elements, _TAG_SAMPLES, end, 1) or 1
    bits_alloc = _us(elements, _TAG_BITS_ALLOC, end, 16) or 16
    bits_stored = _us(elements, _TAG_BITS_STORED, end, bits_alloc) or bits_alloc
    nframes = _intstr(elements, _TAG_FRAMES, 1) or 1
    photometric = elements.get(_TAG_PHOTOMETRIC, b"").decode("ascii", "ignore").strip("\x00 ")
    planar = _us(elements, _TAG_PLANAR, end, 0) or 0

    px = elements.get(_TAG_PIXELDATA)
    if px is None:
        raise ValueError("DICOM: no PixelData")

    if bits_alloc == 8:
        arr = np.frombuffer(px, dtype=np.uint8).astype(np.uint16)
    else:
        arr = np.frombuffer(px, dtype=(">u2" if big else "<u2")).astype(np.uint16)

    per_frame = rows * cols * samples
    frames = []
    for i in range(nframes):
        fr = arr[i * per_frame : (i + 1) * per_frame]
        if len(fr) < per_frame:
            break
        if samples == 3 and planar == 1:
            fr = fr.reshape(3, rows * cols).T.ravel()  # to interleaved
        frames.append(np.ascontiguousarray(fr))

    return DicomImage(
        rows=rows,
        cols=cols,
        frames=frames,
        samples_per_pixel=samples,
        bits_allocated=bits_alloc,
        bits_stored=bits_stored,
        photometric=photometric,
    )
