"""Spatial predictors and the escaped residual stream of the zz and avg
strip modes, encode side.

A numpy copy of the parts of ``mic_tpu.ops.predictors`` the port needs,
with the same names and outputs (pinned by
``tests/test_torch_isolation.py``).  With ``depth = bit_length(maxValue)``,
``thr = (1<<(depth-1))-1`` and ``delim = (1<<depth)-1``, each pixel
encodes as ``thr + diff`` when ``|diff| < thr``, else as ``delim``
followed by the raw pixel (deltacompressu16.go:11-52).
"""

from __future__ import annotations

import numpy as np

__all__ = ["zigzag", "delta_params", "predictor_encode"]

GRAD_SHIFT = 3  # deltagradcompressu16.go:147


def zigzag(x: np.ndarray) -> np.ndarray:
    """int16 -> uint16 ZigZag (deltazigzagcompressu16.go:108-111)."""
    x = np.asarray(x, dtype=np.int16)
    return ((x.astype(np.uint16) << np.uint16(1)) ^ (x >> np.int16(15)).astype(np.uint16))


def delta_params(max_value: int) -> tuple[int, int]:
    """(delta_threshold, delimiter) for a given maxValue
    (deltacompressu16.go:12-14)."""
    depth = int(max_value).bit_length()
    thr = (1 << (depth - 1)) - 1
    delim = (1 << depth) - 1
    return thr, delim


def _predict(kind: str, w, n, nw, ne):
    """Vectorized predictor on int64 neighbour arrays."""
    if kind == "avg":
        return (w + n) >> 1
    if kind == "med":
        mx = np.maximum(w, n)
        mn = np.minimum(w, n)
        return np.where(nw >= mx, mn, np.where(nw <= mn, mx, w + n - nw))
    if kind == "grad":
        avg = (w + n) >> 1
        g = np.abs(w - nw) + np.abs(n - nw)
        corr = (ne - nw) >> GRAD_SHIFT
        limit = g >> 1
        corr = np.clip(corr, -limit, limit)
        return np.where(g == 0, avg, avg + corr)
    raise ValueError(f"unknown predictor {kind!r}")


def _full_predictions(img: np.ndarray, kind: str) -> np.ndarray:
    """Per-pixel predictions from the original neighbours (encode side):
    the corner predicts 0, row 0 predicts left, column 0 predicts top."""
    h, w = img.shape
    p = img.astype(np.int64)
    left = np.zeros_like(p)
    left[:, 1:] = p[:, :-1]
    top = np.zeros_like(p)
    top[1:, :] = p[:-1, :]
    topleft = np.zeros_like(p)
    topleft[1:, 1:] = p[:-1, :-1]
    topright = np.zeros_like(p)
    topright[1:, :-1] = p[:-1, 1:]
    # NE falls back to NW on the last column (deltagradcompressu16.go:42-45).
    topright[1:, -1] = p[:-1, -2] if w >= 2 else 0

    pred = _predict(kind, left, top, topleft, topright)
    if h > 0:
        pred[0, 1:] = left[0, 1:]  # row 0: left only
    if w > 0:
        pred[1:, 0] = top[1:, 0]  # col 0: top only
    pred[0, 0] = 0
    return pred


def predictor_encode(img: np.ndarray, width: int, height: int, max_value: int,
                     kind: str) -> np.ndarray:
    """Residual symbol stream (without any leading maxValue word) of a 2D
    predictor."""
    img = np.asarray(img, dtype=np.uint16).reshape(height, width)
    thr, delim = delta_params(max_value)
    pred = _full_predictions(img, kind)
    diff = img.astype(np.int64) - pred
    escape = np.abs(diff) >= thr
    return _interleave_escapes(
        (thr + diff).astype(np.uint16).ravel(), img.ravel(), escape.ravel(), delim
    )


def _interleave_escapes(
    coded: np.ndarray, raw: np.ndarray, escape: np.ndarray, delim: int
) -> np.ndarray:
    """Build the escaped stream: coded symbol, or [delim, raw] per pixel."""
    n = coded.size
    sizes = np.where(escape, 2, 1).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    out = np.empty(int(starts[-1] + sizes[-1]) if n else 0, dtype=np.uint16)
    out[starts] = np.where(escape, delim, coded)
    esc_idx = starts[escape] + 1
    out[esc_idx] = raw[escape]
    return out
