"""YCoCg-R transform of the reference's RGB planes (ycocgr.go,
asm_generic.go:25-53): numpy copies of ``mic_tpu.ops.color``'s
``ycocgr_forward`` and ``ycocgr_inverse`` (pinned by
``tests/test_torch_isolation.py`` and ``tests/test_torch_kernels.py``).

    Co = R - B;  t = B + (Co >> 1);  Cg = G - t;  Y = t + (Cg >> 1)
    t = Y - (Cg >> 1);  G = Cg + t;  B = t - (Co >> 1);  R = Co + B

with Co and Cg stored ZigZag-mapped as uint16 planes.
"""

from __future__ import annotations

import numpy as np

from .predictors import unzigzag, zigzag

__all__ = ["ycocgr_forward", "ycocgr_inverse"]


def ycocgr_forward(rgb: np.ndarray, width: int, height: int):
    """Interleaved RGB bytes -> (y, co, cg) uint16 planes."""
    n = width * height
    px = np.asarray(rgb, dtype=np.uint8).reshape(n, 3).astype(np.int32)
    r, g, b = px[:, 0], px[:, 1], px[:, 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return (
        y.astype(np.uint16),
        zigzag(co.astype(np.int16)),
        zigzag(cg.astype(np.int16)),
    )


def ycocgr_inverse(y: np.ndarray, co: np.ndarray, cg: np.ndarray, width: int, height: int) -> np.ndarray:
    """(y, co, cg) planes -> interleaved RGB bytes."""
    n = width * height
    yv = np.asarray(y, dtype=np.uint16).astype(np.int32)
    cov = unzigzag(np.asarray(co, dtype=np.uint16)).astype(np.int32)
    cgv = unzigzag(np.asarray(cg, dtype=np.uint16)).astype(np.int32)
    t = yv - (cgv >> 1)
    g = cgv + t
    b = t - (cov >> 1)
    r = cov + b
    out = np.empty((n, 3), dtype=np.uint8)
    out[:, 0] = r.astype(np.uint8)
    out[:, 1] = g.astype(np.uint8)
    out[:, 2] = b.astype(np.uint8)
    return out.ravel()
