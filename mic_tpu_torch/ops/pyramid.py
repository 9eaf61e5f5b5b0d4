"""Pyramid downsampling: 2x2 box filter with +2 rounding, odd trailing
pixels dropped (reference wsipyramid.go:10-55).  A numpy copy of
``mic_tpu.ops.pyramid`` (``downsample2x_rgb`` pinned by
``tests/test_torch_wsi_device.py``, ``downsample2x_grey`` by
``tests/test_torch_host_writers.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["downsample2x_rgb", "downsample2x_grey"]


def downsample2x_rgb(src: np.ndarray, width: int, height: int):
    """Halve an interleaved RGB byte image.  Returns (data, w, h) or
    (None, 0, 0) when too small, matching Downsample2xRGB."""
    new_w, new_h = width // 2, height // 2
    if new_w == 0 or new_h == 0:
        return None, 0, 0
    a = np.asarray(src, dtype=np.uint8).reshape(height, width, 3).astype(np.uint32)
    a = a[: new_h * 2, : new_w * 2]
    q = (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) // 4
    return q.astype(np.uint8).ravel(), new_w, new_h


def downsample2x_grey(src: np.ndarray, width: int, height: int):
    """Halve a greyscale uint16 image (Downsample2xGrey)."""
    new_w, new_h = width // 2, height // 2
    if new_w == 0 or new_h == 0:
        return None, 0, 0
    a = np.asarray(src, dtype=np.uint16).reshape(height, width).astype(np.uint32)
    a = a[: new_h * 2, : new_w * 2]
    q = (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) // 4
    return q.astype(np.uint16).ravel(), new_w, new_h
