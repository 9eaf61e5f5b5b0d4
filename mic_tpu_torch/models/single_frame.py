"""Host decode of the reference's single-frame blobs (Delta+RLE+FSE):
copies of ``mic_tpu.models.single_frame.decompress_single_frame`` and
``decompress_single_frame_grad`` (pinned by ``tests/test_torch_ingest.py``).
This is the Python tier ``tpu/ingest.py`` runs with ``entropy="native"``.
"""

from __future__ import annotations

import numpy as np

from ..ops.deltarle import delta_rle_decompress, grad_delta_rle_decompress
from ..ops.fse_codec import fse_decompress_auto

__all__ = ["decompress_single_frame", "decompress_single_frame_grad"]


def decompress_single_frame(blob: bytes, width, height) -> np.ndarray:
    """Auto-dispatch decode (multiframecompress.go:97): FSE magic sniffing
    then Delta+RLE inversion."""
    return delta_rle_decompress(fse_decompress_auto(blob), width, height)


def decompress_single_frame_grad(blob: bytes, width, height) -> np.ndarray:
    """Reference DecompressSingleFrameGrad (multiframecompress.go:132)."""
    return grad_delta_rle_decompress(fse_decompress_auto(blob), width, height)
