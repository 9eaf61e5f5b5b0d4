"""Fused predictor + RLE pipelines of the reference formats.

A numpy copy of ``mic_tpu.ops.deltarle`` (same names, same outputs; the
decoders pinned by ``tests/test_torch_isolation.py``, the encoders by
``tests/test_torch_host_writers.py``), plus
``med_delta_rle_decompress``: the med predictor through the same fused
decode, which is what ``mic_tpu``'s C++ tier decodes a kind-2 frame with
(pinned against it, where it is built, by ``tests/test_torch_ingest.py``).
Stream layout (deltarlecompressu16.go:24-67): an RLE stream whose Init
maxValue word is the delimiter for the pixel depth, and whose first
encoded symbol is the image's true maxValue, followed by the escaped
residual symbols, with no length prefix.  The encode runs the escaped
residual stream through ``ops.rle.RleEncoder`` one symbol at a time
(the bytes are its state machine's); the decode is two passes: full
RLE expansion, then the predictor inversion.
"""

from __future__ import annotations

import numpy as np

from .predictors import (_zz_escaped, delta_params, parse_escaped, predictor_decode,
                         predictor_encode)
from .rle import RleEncoder, rle_decompress_stream

__all__ = ["delta_rle_compress", "delta_rle_decompress", "grad_delta_rle_compress",
           "grad_delta_rle_decompress", "med_delta_rle_decompress", "zz_delta_rle_compress",
           "zz_delta_rle_decompress"]


def _fused_compress(img, width: int, height: int, max_value: int, kind: str) -> np.ndarray:
    _thr, delim = delta_params(max_value)
    if kind == "zz":
        stream = _zz_escaped(img, width, height, max_value)
    else:
        stream = predictor_encode(img, width, height, max_value, kind)

    rle = RleEncoder(width, height, delim)
    enc = rle.encode
    enc(int(max_value))
    for v in stream.tolist():
        enc(v)
    rle.flush()
    return np.array(rle.out, dtype=np.uint16)


def _fused_decompress(stream, width: int, height: int, kind: str) -> np.ndarray:
    symbols, _mid = rle_decompress_stream(stream)
    max_value = int(symbols[0])
    _, delim = delta_params(max_value)
    values, is_raw = parse_escaped(symbols[1:], delim, width * height)
    return predictor_decode(values, is_raw, width, height, max_value, kind).ravel()


def delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference DeltaRleCompressU16.Compress (deltarlecompressu16.go:24)."""
    return _fused_compress(img, width, height, max_value, "avg")


def delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference DeltaRleDecompressU16.Decompress (deltarlecompressu16.go:69)."""
    return _fused_decompress(stream, width, height, "avg")


def grad_delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference GradDeltaRleCompressU16 (deltagradrlecompressu16.go:26)."""
    return _fused_compress(img, width, height, max_value, "grad")


def grad_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference GradDeltaRleDecompressU16 (deltagradrlecompressu16.go:71)."""
    return _fused_decompress(stream, width, height, "grad")


def med_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """The fused decode with the MED predictor (deltamedcompressu16.go:56
    behind the RLE stage)."""
    return _fused_decompress(stream, width, height, "med")


def zz_delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference DeltaRleZZU16.Compress (deltazzrlecompressu16.go:15)."""
    return _fused_compress(img, width, height, max_value, "zz")


def zz_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference DeltaRleZZU16.Decompress (deltazzrlecompressu16.go:49)."""
    return _fused_decompress(stream, width, height, "zz")
