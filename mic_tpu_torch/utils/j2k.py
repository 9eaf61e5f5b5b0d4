"""Lossless JPEG 2000 baseline via OpenJPEG (Pillow bindings).

A copy of ``mic_tpu.utils.j2k`` (same names, same bytes; pinned by
``tests/test_torch_comparators.py`` where the codec is present).  The
reference validates its headline ratio claim in-process against
OpenJPH's HTJ2K (ojph/ojph_wrapper.cpp:17-125, reversible 5/3 lifting,
ojph/htj2k_fair_comparison_test.go).  OpenJPEG (``libopenjp2``), through
Pillow's JPEG2000 plugin, stands in: JPEG 2000 Part 1 with
``irreversible=False`` uses the *same* reversible 5/3 wavelet as the
reference's HTJ2K configuration; only the block coder differs (EBCOT vs
HT), and for lossless coding EBCOT compresses at least as well as the
faster HT coder.  So the column this module provides is a
*conservative* stand-in for the reference's HTJ2K ratio column.

Gated like the other baselines: :func:`available` is False when the
Pillow J2K codec is missing.
"""

from __future__ import annotations

import io
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=1)
def available() -> bool:
    try:
        from PIL import features

        return bool(features.check("jpg_2000"))
    except Exception:  # noqa: BLE001 — any import/probe failure gates cleanly
        return False


def encode(img: np.ndarray) -> bytes:
    """Lossless J2K encode.

    ``img`` is either (h, w) uint16 greyscale or (h, w, 3) uint8 RGB —
    the two shapes the reference pushes through its OpenJPH wrapper
    (ojph_wrapper.cpp:30-68 plans one component per plane; Pillow's
    plugin handles the planar split).
    """
    if not available():
        raise RuntimeError("Pillow JPEG2000 codec not available")
    from PIL import Image

    if img.ndim == 2 and img.dtype == np.uint16:
        im = Image.frombytes("I;16", (img.shape[1], img.shape[0]),
                             np.ascontiguousarray(img).tobytes())
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        im = Image.fromarray(img, mode="RGB")
    else:
        raise ValueError(f"unsupported image {img.shape} {img.dtype}")
    buf = io.BytesIO()
    im.save(buf, format="JPEG2000", irreversible=False)
    return buf.getvalue()


def decode(blob: bytes) -> np.ndarray:
    """Decode a J2K codestream back to the numpy layout ``encode`` took."""
    if not available():
        raise RuntimeError("Pillow JPEG2000 codec not available")
    from PIL import Image

    im = Image.open(io.BytesIO(blob))
    im.load()
    arr = np.array(im)
    if arr.dtype == np.int32:  # Pillow promotes I;16 reads on some paths
        arr = arr.astype(np.uint16)
    return arr
