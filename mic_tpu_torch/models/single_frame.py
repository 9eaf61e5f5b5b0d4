"""Single-frame orchestrators of the reference formats: Delta+RLE+FSE
with state-count fallbacks (reference multiframecompress.go:15-175).

A copy of ``mic_tpu.models.single_frame`` (same names, same bytes; the
decoders pinned by ``tests/test_torch_ingest.py``, the encoders by
``tests/test_torch_host_writers.py``, the Huffman pair by
``tests/test_torch_wavelet_huffman_gap.py``).  Each N-state encoder falls
back down the chain N -> ... -> 1 when the entropy stage rejects the
input, as the reference does.  The explicit decoders are the Python tier
(``tpu/ingest.py`` runs it with ``entropy="python"``); ``decode_frame``
routes to the C++ tier (``..native``) by default, as ``mic_tpu`` does
with its library built.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..ops.deltarle import (
    delta_rle_compress,
    delta_rle_decompress,
    grad_delta_rle_compress,
    grad_delta_rle_decompress,
)
from ..ops.fse import IncompressibleError, UseRLEError
from ..ops.fse_codec import (
    fse_compress,
    fse_compress_2state,
    fse_compress_4state,
    fse_compress_8state,
    fse_decompress_auto,
)
from ..ops.huffman import can_huffman_compress, can_huffman_decompress
from ..ops.rans import rans_compress_8state
from ..ops.rle import RleEncoder, rle_decompress

__all__ = [
    "compress_single_frame",
    "compress_single_frame_4state",
    "compress_single_frame_8state",
    "compress_single_frame_rans8",
    "compress_single_frame_grad",
    "decompress_single_frame",
    "decompress_single_frame_grad",
    "compress_residual_frame",
    "compress_single_frame_huffman",
    "decompress_single_frame_huffman",
    "decompress_residual_frame",
    "decode_frame",
]

_FALLBACKS = {
    1: (fse_compress,),
    2: (fse_compress_2state, fse_compress),
    4: (fse_compress_4state, fse_compress_2state, fse_compress),
    8: (
        fse_compress_8state,
        fse_compress_4state,
        fse_compress_2state,
        fse_compress,
    ),
}


def _fse_chain(symbols: np.ndarray, n_states: int) -> bytes:
    """Fall down the state-count chain on *any* coder error, matching the
    reference's ``if err != nil`` fallbacks (multiframecompress.go:25-31,
    48-58, 76-90) — this includes normalization corner-case errors, not
    just UseRLE/Incompressible."""
    last: Exception | None = None
    for comp in _FALLBACKS[n_states]:
        try:
            return comp(symbols)
        except (IncompressibleError, UseRLEError, ValueError) as e:
            last = e
    raise last if last is not None else IncompressibleError()


def compress_single_frame(pixels, width, height, max_value) -> bytes:
    """Delta+RLE+FSE(2-state, fallback 1) — reference CompressSingleFrame
    (multiframecompress.go:15)."""
    rle = delta_rle_compress(pixels, width, height, max_value)
    return _fse_chain(rle, 2)


def compress_single_frame_4state(pixels, width, height, max_value) -> bytes:
    """4-state chain 4->2->1 (multiframecompress.go:38)."""
    rle = delta_rle_compress(pixels, width, height, max_value)
    return _fse_chain(rle, 4)


def compress_single_frame_8state(pixels, width, height, max_value) -> bytes:
    """8-state chain 8->4->2->1 (multiframecompress.go:67)."""
    rle = delta_rle_compress(pixels, width, height, max_value)
    return _fse_chain(rle, 8)


def compress_single_frame_rans8(pixels, width, height, max_value) -> bytes:
    """Delta+RLE+rANS(8-state), falling back through the FSE chain.

    The reference exposes rANS-8 as a stand-alone coder behind its own
    magic (rans8state.go:31); DecompressSingleFrame auto-detects it.
    """
    rle = delta_rle_compress(pixels, width, height, max_value)
    try:
        return rans_compress_8state(rle)
    except (IncompressibleError, UseRLEError):
        return _fse_chain(rle, 4)


def decompress_single_frame(blob: bytes, width, height) -> np.ndarray:
    """Auto-dispatch decode (multiframecompress.go:97): FSE magic sniffing
    then Delta+RLE inversion."""
    return delta_rle_decompress(fse_decompress_auto(blob), width, height)


def compress_single_frame_grad(pixels, width, height, max_value) -> bytes:
    """Gradient-predictor pipeline, 2->1 chain (multiframecompress.go:111)."""
    rle = grad_delta_rle_compress(pixels, width, height, max_value)
    return _fse_chain(rle, 2)


def decompress_single_frame_grad(blob: bytes, width, height) -> np.ndarray:
    """Reference DecompressSingleFrameGrad (multiframecompress.go:132)."""
    return grad_delta_rle_decompress(fse_decompress_auto(blob), width, height)


def compress_residual_frame(residuals, max_value) -> bytes:
    """RLE+FSE for temporal residuals — no spatial delta, since ZigZag
    temporal residuals lack spatial correlation (multiframecompress.go:144-175).

    The RLE maxValue is floored at 255, the same guard the reference's WSI
    plane coder applies (wsicompress.go:398-400): a tiny maxValue gives a
    tiny RLE midCount, and midCount <= 3 makes the run-length state machine
    emit count-0 blocks that no decoder parses correctly.  The decoder
    derives midCount from the stream's own leading maxValue word.
    """
    residuals = np.asarray(residuals, dtype=np.uint16)
    mv = max(int(max_value), 255)
    rle = RleEncoder(len(residuals), 1, mv)
    rle_out = rle.compress(residuals)
    return _fse_chain(rle_out, 2)


def decompress_residual_frame(blob: bytes) -> np.ndarray:
    return rle_decompress(fse_decompress_auto(blob))


def compress_single_frame_huffman(pixels, width, height, max_value) -> bytes:
    """Delta+RLE+canonical-Huffman pipeline (the encode side of the
    reference's deltarlehuffdecompressu16.go / rlehuffdecompressu16.go
    decode stack; benched as BenchmarkDeltaRLEHuffCompress)."""
    rle = delta_rle_compress(pixels, width, height, max_value)
    return can_huffman_compress(rle)


def decompress_single_frame_huffman(blob: bytes, width, height) -> np.ndarray:
    """Inverse of compress_single_frame_huffman: Huffman → RLE → delta."""
    rle = can_huffman_decompress(blob)
    return delta_rle_decompress(rle, width, height)


def decode_frame(blob: bytes, width: int, height: int, kind: str = "avg", tier: str = "auto"):
    """Tier-routing decode convenience: ``"auto"`` and ``"native"`` run the
    C++ tier (kinds 'avg', 'grad', 'med', 'zz'), ``"python"`` (or any
    other value, as in ``mic_tpu``) the numpy tier (kinds 'avg' and
    'grad').  There is no fallback: a native error or a failed build
    raises.

    The explicit decompress_single_frame* functions always use the numpy
    tier (they are the cross-tier correctness oracle)."""
    if tier in ("auto", "native"):
        kmap = {"avg": native.PRED_AVG, "grad": native.PRED_GRAD,
                "med": native.PRED_MED, "zz": native.PRED_ZZ}
        if kind not in kmap:
            raise ValueError(f"unsupported kind for native tier: {kind}")
        return native.decompress_frame_native(blob, width, height, kmap[kind])
    if kind == "avg":
        return decompress_single_frame(blob, width, height)
    if kind == "grad":
        return decompress_single_frame_grad(blob, width, height)
    raise ValueError(f"unsupported kind for python tier: {kind}")
