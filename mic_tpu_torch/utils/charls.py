"""JPEG-LS (CharLS) bindings via ctypes for the comparison harness.

A copy of ``mic_tpu.utils.charls`` (same names, same bytes; pinned by
``tests/test_torch_comparators.py`` where the library is present).  The
reference validates its ratio claims in-process against CharLS
(ojph/charls_wrapper.cpp:9-75, ojph/jpegls_comparison_test.go); this is
the ctypes analog against the system ``libcharls.so.2`` (CharLS 2.x
public C API).  Gated: :func:`available` is False when the shared
library is absent and every entry point raises cleanly.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np


class _FrameInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_int32),
        ("component_count", ctypes.c_int32),
    ]


@lru_cache(maxsize=1)
def _lib():
    for name in ("libcharls.so.2", "charls", "libcharls.so"):
        try:
            if name == "charls":
                found = ctypes.util.find_library("charls")
                if not found:
                    continue
                name = found
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    P = ctypes.POINTER
    lib.charls_jpegls_encoder_create.restype = ctypes.c_void_p
    lib.charls_jpegls_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.charls_jpegls_encoder_set_frame_info.argtypes = [ctypes.c_void_p, P(_FrameInfo)]
    lib.charls_jpegls_encoder_set_interleave_mode.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.charls_jpegls_encoder_set_near_lossless.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.charls_jpegls_encoder_get_estimated_destination_size.argtypes = [
        ctypes.c_void_p, P(ctypes.c_size_t)]
    lib.charls_jpegls_encoder_set_destination_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.charls_jpegls_encoder_encode_from_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.charls_jpegls_encoder_get_bytes_written.argtypes = [
        ctypes.c_void_p, P(ctypes.c_size_t)]
    lib.charls_jpegls_decoder_create.restype = ctypes.c_void_p
    lib.charls_jpegls_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.charls_jpegls_decoder_set_source_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.charls_jpegls_decoder_read_header.argtypes = [ctypes.c_void_p]
    lib.charls_jpegls_decoder_get_frame_info.argtypes = [ctypes.c_void_p, P(_FrameInfo)]
    lib.charls_jpegls_decoder_get_destination_size.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, P(ctypes.c_size_t)]
    lib.charls_jpegls_decoder_decode_to_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    return lib


def available() -> bool:
    return _lib() is not None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"charls: {what} failed (errc={rc})")


def encode(img: np.ndarray, bits_per_sample: int | None = None) -> bytes:
    """Lossless JPEG-LS encode.

    ``img`` is (h, w) uint8/uint16 grayscale or (h, w, 3) uint8 RGB
    (sample-interleaved, the reference wrapper's ILV=sample mode).
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("libcharls not available")
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        comps = 1
    elif img.ndim == 3 and img.shape[2] == 3:
        comps = 3
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    if bits_per_sample is None:
        bits_per_sample = 8 * img.dtype.itemsize
    if bits_per_sample <= 8 and img.dtype.itemsize == 2:
        # CharLS stores 1 byte/sample when bps <= 8; feeding a u16
        # buffer would make it encode interleaved lo/hi bytes.
        img = np.ascontiguousarray(img.astype(np.uint8))
    h, w = img.shape[:2]
    fi = _FrameInfo(w, h, bits_per_sample, comps)
    enc = lib.charls_jpegls_encoder_create()
    if not enc:
        raise RuntimeError("charls: encoder_create failed")
    try:
        _check(lib.charls_jpegls_encoder_set_frame_info(enc, ctypes.byref(fi)),
               "set_frame_info")
        if comps == 3:
            _check(lib.charls_jpegls_encoder_set_interleave_mode(enc, 2),
                   "set_interleave_mode")
        _check(lib.charls_jpegls_encoder_set_near_lossless(enc, 0),
               "set_near_lossless")
        est = ctypes.c_size_t(0)
        _check(lib.charls_jpegls_encoder_get_estimated_destination_size(
            enc, ctypes.byref(est)), "get_estimated_destination_size")
        dst = (ctypes.c_uint8 * est.value)()
        _check(lib.charls_jpegls_encoder_set_destination_buffer(
            enc, dst, est.value), "set_destination_buffer")
        src = img.tobytes()
        _check(lib.charls_jpegls_encoder_encode_from_buffer(
            enc, src, len(src), 0), "encode_from_buffer")
        written = ctypes.c_size_t(0)
        _check(lib.charls_jpegls_encoder_get_bytes_written(
            enc, ctypes.byref(written)), "get_bytes_written")
        return bytes(bytearray(dst)[: written.value])
    finally:
        lib.charls_jpegls_encoder_destroy(enc)


def decode(blob: bytes) -> np.ndarray:
    """Decode a JPEG-LS stream to (h, w) or (h, w, 3)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libcharls not available")
    dec = lib.charls_jpegls_decoder_create()
    if not dec:
        raise RuntimeError("charls: decoder_create failed")
    try:
        _check(lib.charls_jpegls_decoder_set_source_buffer(dec, blob, len(blob)),
               "set_source_buffer")
        _check(lib.charls_jpegls_decoder_read_header(dec), "read_header")
        fi = _FrameInfo()
        _check(lib.charls_jpegls_decoder_get_frame_info(dec, ctypes.byref(fi)),
               "get_frame_info")
        size = ctypes.c_size_t(0)
        _check(lib.charls_jpegls_decoder_get_destination_size(
            dec, 0, ctypes.byref(size)), "get_destination_size")
        dst = (ctypes.c_uint8 * size.value)()
        _check(lib.charls_jpegls_decoder_decode_to_buffer(
            dec, dst, size.value, 0), "decode_to_buffer")
        dtype = np.uint16 if fi.bits_per_sample > 8 else np.uint8
        out = np.frombuffer(bytearray(dst), dtype=dtype)
        if fi.component_count == 1:
            return out.reshape(fi.height, fi.width)
        return out.reshape(fi.height, fi.width, fi.component_count)
    finally:
        lib.charls_jpegls_decoder_destroy(dec)
