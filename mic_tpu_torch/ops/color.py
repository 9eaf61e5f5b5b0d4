"""YCoCg-R inverse of the reference's RGB planes (ycocgr.go,
asm_generic.go:25-53): a numpy copy of ``mic_tpu.ops.color.ycocgr_inverse``
(pinned by ``tests/test_torch_isolation.py``).

    t = Y - (Cg >> 1);  G = Cg + t;  B = t - (Co >> 1);  R = Co + B

with Co and Cg stored ZigZag-mapped as uint16 planes.
"""

from __future__ import annotations

import numpy as np

from .predictors import unzigzag

__all__ = ["ycocgr_inverse"]


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
