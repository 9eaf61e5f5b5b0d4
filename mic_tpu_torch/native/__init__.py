"""ctypes bindings for the native host tier (``micfse.cpp``).

A copy of ``mic_tpu.native`` over the port's own build of the same
source: the fastest single-host encode and decode of the reference
formats' byte streams (MIC1 frames, PICS containers, the FSE / tANS and
rANS coders) and of MICT's host staging (the ncount header, the L-lane
rANS encode).  ``mic_tpu_torch._build.host_library`` compiles
``micfse.cpp`` with the host compiler at the first call of any function
here, never at import.  There is no fallback: where the library cannot
be built, every call raises ``RuntimeError`` with the compiler's output.
A ``None`` return means what it means in ``mic_tpu`` for the same data
(an incompressible strip, a normalization the caller retries, an invalid
header), and the caller takes its Python path exactly where ``mic_tpu``
takes it.  Pinned to ``mic_tpu``'s library and Python tier by
``tests/test_torch_native.py``.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from .._build import host_library

__all__ = [
    "available",
    "compress_frame_native",
    "decompress_frame_native",
    "entropy_compress_native",
    "entropy_decompress_native",
    "decompress_strips_native",
    "compress_strips_native",
    "read_ncount_native",
    "lane_encode_native",
    "normalize_write_count_native",
    "PRED_AVG",
    "PRED_GRAD",
    "PRED_MED",
    "PRED_ZZ",
]

PRED_AVG, PRED_GRAD, PRED_MED, PRED_ZZ = 0, 1, 2, 3


def available() -> bool:
    """Builds the library if needed: True, or the build's ``RuntimeError``
    (kept for ``mic_tpu``'s API; nothing in the port branches on it)."""
    host_library()
    return True


def decompress_frame_native(blob: bytes, width: int, height: int, kind: int = PRED_AVG) -> np.ndarray:
    lib = host_library()
    out = np.empty(width * height, dtype=np.uint16)
    rc = lib.mic_decompress_frame(
        blob, len(blob), width, height, kind, out.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise ValueError(f"native decode failed (code {rc})")
    return out


_VALID_PREDS = (0, 1, 2, 3)  # PRED_AVG/GRAD/MED/ZZ
_VALID_STATES = (1, 2, 4, 8)


def _check_kind_states(kind: int, n_states: int) -> None:
    """Descriptive errors for the classic footgun: passing the state
    count positionally where the predictor goes silently selected an
    invalid predictor — hence keyword-only kind/n_states everywhere."""
    if kind not in _VALID_PREDS:
        raise ValueError(
            f"invalid predictor kind={kind!r}; use PRED_AVG/PRED_GRAD/"
            f"PRED_MED/PRED_ZZ (did you mean n_states={kind}?)")
    if n_states not in _VALID_STATES:
        raise ValueError(f"invalid n_states={n_states!r}; must be 1, 2, 4 or 8")


def compress_frame_native(
    pixels: np.ndarray, width: int, height: int, max_value: int,
    *, kind: int = PRED_AVG, n_states: int = 2,
) -> bytes:
    lib = host_library()
    _check_kind_states(kind, n_states)
    px = np.ascontiguousarray(pixels, dtype=np.uint16)
    cap = px.nbytes * 2 + 4096
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_compress_frame(
        px.ctypes.data_as(ctypes.c_void_p), width, height, max_value, kind,
        n_states, out, cap,
    )
    if n == 0:
        raise ValueError("native compress failed (incompressible or error)")
    return bytes(bytearray(out)[:n])


def entropy_compress_native(symbols: np.ndarray, n_states: int = 4) -> bytes:
    lib = host_library()
    s = np.ascontiguousarray(symbols, dtype=np.uint16)
    cap = s.nbytes * 2 + 4096
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_entropy_compress(s.ctypes.data_as(ctypes.c_void_p), len(s), n_states, out, cap)
    if n == 0:
        raise ValueError("native entropy compress failed")
    return bytes(bytearray(out)[:n])


def entropy_decompress_native(blob: bytes, max_symbols: int) -> np.ndarray:
    lib = host_library()
    out = np.empty(max_symbols, dtype=np.uint16)
    n = lib.mic_entropy_decompress(blob, len(blob), out.ctypes.data_as(ctypes.c_void_p), max_symbols)
    if n == 0:
        raise ValueError("native entropy decompress failed")
    return out[:n]


def read_ncount_native(data: bytes):
    """Native normalized-count header reader (reference fseu16.go
    readNCount semantics; ~1000x the pure-Python nibble loop).  Returns
    (norm int32[symbol_len], symbol_len, table_log, consumed), or None
    where the header is invalid (the caller's Python reader then raises
    its own error, as in ``mic_tpu``)."""
    lib = host_library()
    out = np.zeros(65536, dtype=np.int32)
    meta = np.zeros(2, dtype=np.int32)
    n = lib.mic_read_ncount(
        bytes(data), len(data), out.ctypes.data, 65536, meta.ctypes.data
    )
    if n == 0:
        return None
    sl, tl = int(meta[0]), int(meta[1])
    return out[:sl].copy(), sl, tl, int(n)


def decompress_strips_native(blob: bytes, kind: int = PRED_AVG, n_threads: int = 0):
    """Threaded PICS decode (reference mic_parallel.c analog).  Returns
    (pixels, width, height)."""
    lib = host_library()
    if len(blob) < 20 or blob[:4] != b"PICS":
        raise ValueError("not a PICS container")
    width, height = struct.unpack_from("<II", blob, 4)
    out = np.empty(width * height, dtype=np.uint16)
    rc = lib.mic_decompress_strips(blob, len(blob), kind, out.ctypes.data, n_threads)
    if rc != 0:
        raise ValueError(f"native strips decode failed (code {rc})")
    return out, width, height


def compress_strips_native(pixels: np.ndarray, width: int, height: int,
                           max_value: int, *, kind: int = PRED_AVG,
                           n_states: int = 4, num_strips: int = 0,
                           n_threads: int = 0):
    """Whole-container PICS encode on the native std::thread pool
    (mic_compress_strips — the encode mirror of decompress_strips_native).
    Byte-identical to parallel/strips.py's per-strip assembly.  Returns
    the container bytes, or None when any strip is incompressible (the
    caller then assembles the strips in Python, as ``mic_tpu`` does)."""
    lib = host_library()
    _check_kind_states(kind, n_states)
    px = np.ascontiguousarray(pixels, dtype=np.uint16)
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    cap = px.nbytes * 2 + 4096 + 8 * (num_strips + 2)
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_compress_strips(
        px.ctypes.data_as(ctypes.c_void_p), width, height, max_value,
        kind, n_states, num_strips, n_threads, out, cap,
    )
    if n == 0:
        return None
    return bytes(bytearray(out)[:n])


def _as_u32(a):
    # int32 tables reinterpret for free (values < 2^31); anything else
    # converts.
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    elif a.dtype != np.uint32:
        a = a.astype(np.uint32)
    return np.ascontiguousarray(a)


def lane_encode_native(syms: np.ndarray, lanes: int, table_log: int,
                       freq_of: np.ndarray, cumul_of: np.ndarray,
                       slot_of: np.ndarray | None = None):
    """Reverse lane-interleaved rANS encode (the MICT/FF 41 hot loop);
    returns (states u32[lanes], words u16[n_words]).  Bit for bit
    ``tpu.device_rans._lane_encode_numpy``."""
    lib = host_library()
    syms = np.ascontiguousarray(syms, dtype=np.uint16)
    freq_of = _as_u32(freq_of)
    cumul_of = _as_u32(cumul_of)
    n = len(syms)
    if n and int(syms.max()) >= len(freq_of):
        raise ValueError("lane encode: symbol beyond table range")
    states = np.empty(lanes, dtype=np.uint32)
    words = np.empty(max(n, 1), dtype=np.uint16)
    sl_ptr = None
    if slot_of is not None:
        slot_of = np.ascontiguousarray(slot_of, dtype=np.uint32)
        sl_ptr = slot_of.ctypes.data
    n_words = lib.mic_lane_encode(
        syms.ctypes.data, n, lanes, table_log,
        freq_of.ctypes.data, cumul_of.ctypes.data, sl_ptr,
        states.ctypes.data, words.ctypes.data, len(words),
    )
    if n_words == ctypes.c_size_t(-1).value:
        raise ValueError("native lane encode failed (corrupt tables)")
    return states, words[:n_words].copy()


def normalize_write_count_native(counts: np.ndarray, total: int,
                                 table_log: int, symbol_len: int):
    """Combined normalize_count + write_count (bit-identical to the
    Python pair — the same Go-derived algorithm both sides).  Returns
    (norm int64[symbol_len], header bytes), or None where normalization
    needs the retry the caller's Python pair handles (it then raises the
    same error as in ``mic_tpu``)."""
    lib = host_library()
    c = np.ascontiguousarray(counts[:symbol_len], dtype=np.uint32)
    norm = np.empty(symbol_len, dtype=np.int32)
    cap = 2 * symbol_len + 64
    hdr = np.empty(cap, dtype=np.uint8)
    n = lib.mic_normalize_write_count(
        c.ctypes.data, total, table_log, symbol_len,
        norm.ctypes.data, hdr.ctypes.data, cap,
    )
    if n == 0:
        return None
    return norm.astype(np.int64), hdr[:n].tobytes()
