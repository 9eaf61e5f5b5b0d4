"""``mic_tpu_torch.utils.dicom.read_dicom`` against ``mic_tpu.utils.dicom``
on DICOM part-10 files built in memory from seeded pixels (the NEMA
corpus is not in the repo): explicit VR little endian (16-bit
MONOCHROME2, one frame and several), implicit VR little endian, explicit
VR big endian, 8-bit RGB with planar configuration 0 and 1, sequences of
defined and undefined length before PixelData, a dataset with no
preamble, read from bytes and from a path.  Every field and every frame
must be equal, and equal to the pixels the file was built from; on a
file neither can read, both raise the same error.
"""

import struct
from dataclasses import fields

import numpy as np
import pytest

from mic_tpu.utils import dicom as ref_dicom
from mic_tpu_torch.utils import dicom

TS = {"implicit": "1.2.840.10008.1.2", "explicit": "1.2.840.10008.1.2.1",
      "big": "1.2.840.10008.1.2.2"}
_LONG = {b"OB", b"OW", b"SQ", b"UN", b"UT"}


def _pad(b: bytes, fill=b" ") -> bytes:
    return b + fill if len(b) % 2 else b


def _elem(tag, vr: bytes, value: bytes, explicit: bool, big: bool) -> bytes:
    end = ">" if big else "<"
    head = struct.pack(end + "HH", *tag)
    if not explicit:
        return head + struct.pack(end + "I", len(value)) + value
    if vr in _LONG:
        return head + vr + b"\0\0" + struct.pack(end + "I", len(value)) + value
    return head + vr + struct.pack(end + "H", len(value)) + value


def _sequences(explicit: bool, big: bool, undefined_item: bool) -> bytes:
    """A defined-length sequence and an undefined-length one, each with one
    item (of undefined length in the second where ``undefined_item``),
    before the image elements."""
    end = ">" if big else "<"
    inner = _elem((0x0008, 0x1150), b"UI", _pad(b"1.2.3", b"\0"), explicit, big)
    item = struct.pack(end + "HHI", 0xFFFE, 0xE000, len(inner)) + inner
    defined = _elem((0x0008, 0x1140), b"SQ", item, explicit, big)
    undef_item = (struct.pack(end + "HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + inner
                  + struct.pack(end + "HHI", 0xFFFE, 0xE00D, 0)) if undefined_item else item
    head = struct.pack(end + "HH", 0x0008, 0x1115)
    head += (b"SQ\0\0" if explicit else b"") + struct.pack(end + "I", 0xFFFFFFFF)
    undefined = head + undef_item + struct.pack(end + "HHI", 0xFFFE, 0xE0DD, 0)
    return defined + undefined


def build_dicom(frames, rows, cols, samples=1, bits=16, ts="explicit", planar=0,
                photometric="MONOCHROME2", sequence=False, preamble=True,
                undefined_item=None) -> bytes:
    explicit, big = ts != "implicit", ts == "big"
    end = ">" if big else "<"
    us = lambda v: struct.pack(end + "H", v)  # noqa: E731
    if undefined_item is None:
        undefined_item = not explicit
    body = _sequences(explicit, big, undefined_item) if sequence else b""
    body += _elem((0x0028, 0x0002), b"US", us(samples), explicit, big)
    body += _elem((0x0028, 0x0004), b"CS", _pad(photometric.encode()), explicit, big)
    if samples == 3:
        body += _elem((0x0028, 0x0006), b"US", us(planar), explicit, big)
    if len(frames) > 1:
        body += _elem((0x0028, 0x0008), b"IS", _pad(str(len(frames)).encode()), explicit, big)
    body += _elem((0x0028, 0x0010), b"US", us(rows), explicit, big)
    body += _elem((0x0028, 0x0011), b"US", us(cols), explicit, big)
    body += _elem((0x0028, 0x0100), b"US", us(bits), explicit, big)
    body += _elem((0x0028, 0x0101), b"US", us(bits if bits == 8 else 12), explicit, big)
    body += _elem((0x0028, 0x0103), b"US", us(0), explicit, big)
    dtype = np.uint8 if bits == 8 else (">u2" if big else "<u2")
    stored = []
    for f in frames:
        f = np.asarray(f)
        if samples == 3 and planar == 1:
            f = f.reshape(rows * cols, 3).T  # planes R, G, B
        stored.append(np.ascontiguousarray(f).astype(dtype).tobytes())
    px = b"".join(stored)
    body += _elem((0x7FE0, 0x0010), b"OB" if bits == 8 else b"OW", _pad(px, b"\0"), explicit, big)
    if not preamble:
        return body
    meta = _elem((0x0002, 0x0010), b"UI", _pad(TS[ts].encode(), b"\0"), True, False)
    meta = _elem((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta)), True, False) + meta
    return bytes(128) + b"DICM" + meta + body


def _grey(rows, cols, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((rows, cols)).cumsum(1) * 40 + 2000
    return [np.clip(base + 17 * k, 0, 4095).astype(np.uint16).ravel() for k in range(n)]


def _rgb(rows, cols, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, rows * cols * 3).astype(np.uint16)]


CASES = {
    "explicit_le_one_frame": dict(frames=_grey(40, 33, 1, 1), rows=40, cols=33),
    "explicit_le_frames": dict(frames=_grey(24, 20, 5, 2), rows=24, cols=20),
    "implicit_le": dict(frames=_grey(31, 18, 2, 3), rows=31, cols=18, ts="implicit"),
    "explicit_be": dict(frames=_grey(17, 26, 3, 4), rows=17, cols=26, ts="big"),
    "rgb_planar0": dict(frames=_rgb(20, 15, 5), rows=20, cols=15, samples=3, bits=8,
                        photometric="RGB"),
    "rgb_planar1": dict(frames=_rgb(20, 15, 6), rows=20, cols=15, samples=3, bits=8,
                        planar=1, photometric="RGB"),
    "sequence_explicit": dict(frames=_grey(30, 30, 1, 7), rows=30, cols=30, sequence=True),
    "sequence_implicit": dict(frames=_grey(30, 30, 2, 8), rows=30, cols=30, ts="implicit",
                              sequence=True),
    "no_preamble": dict(frames=_grey(30, 12, 1, 9), rows=30, cols=12, ts="implicit",
                        preamble=False),
}


def _same_image(a, b):
    for f in fields(ref_dicom.DicomImage):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "frames":
            assert len(va) == len(vb)
            assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(va, vb))
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_dicom_matches_reference(case, tmp_path):
    spec = CASES[case]
    data = build_dicom(**spec)
    got, want = dicom.read_dicom(data), ref_dicom.read_dicom(data)
    _same_image(got, want)
    assert got.rows == spec["rows"] and got.cols == spec["cols"]
    assert all(np.array_equal(g, np.asarray(f, np.uint16)) for g, f in zip(got.frames,
                                                                         spec["frames"]))
    assert got.max_value == max(int(f.max()) for f in spec["frames"])
    path = tmp_path / "image.dcm"
    path.write_bytes(data)
    _same_image(dicom.read_dicom(str(path)), got)


def test_read_dicom_errors_match():
    good = build_dicom(**CASES["explicit_le_one_frame"])
    no_pixels = good[: good.rindex(b"\xe0\x7f\x10\x00")] + bytes(300)
    no_dims = build_dicom(**CASES["explicit_le_one_frame"]).replace(
        b"\x28\x00\x10\x00US", b"\x28\x00\x10\x01US")
    # Both readers skip an undefined-length item by 8-byte element headers,
    # which explicit VR does not have: the elements after it are lost.
    explicit_undefined_item = build_dicom(**CASES["sequence_explicit"], undefined_item=True)
    for data in (no_pixels, no_dims, explicit_undefined_item):
        with pytest.raises(ValueError) as got:
            dicom.read_dicom(data)
        with pytest.raises(ValueError) as want:
            ref_dicom.read_dicom(data)
        assert str(got.value) == str(want.value)
