"""Fused predictor + RLE pipelines of the reference formats, decode side.

A numpy copy of the decode half of ``mic_tpu.ops.deltarle`` (same
names, same outputs; pinned by ``tests/test_torch_isolation.py``).
Stream layout (deltarlecompressu16.go:24-67): an RLE stream whose Init
maxValue word is the delimiter for the pixel depth, and whose first
encoded symbol is the image's true maxValue, followed by the escaped
residual symbols, with no length prefix.  The decode is two passes:
full RLE expansion, then the predictor inversion.
"""

from __future__ import annotations

import numpy as np

from .predictors import delta_params, parse_escaped, predictor_decode
from .rle import rle_decompress_stream

__all__ = ["delta_rle_decompress", "grad_delta_rle_decompress"]


def _fused_decompress(stream, width: int, height: int, kind: str) -> np.ndarray:
    symbols, _mid = rle_decompress_stream(stream)
    max_value = int(symbols[0])
    _, delim = delta_params(max_value)
    values, is_raw = parse_escaped(symbols[1:], delim, width * height)
    return predictor_decode(values, is_raw, width, height, max_value, kind).ravel()


def delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference DeltaRleDecompressU16.Decompress (deltarlecompressu16.go:69)."""
    return _fused_decompress(stream, width, height, "avg")


def grad_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference GradDeltaRleDecompressU16 (deltagradrlecompressu16.go:71)."""
    return _fused_decompress(stream, width, height, "grad")
