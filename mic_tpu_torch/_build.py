"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
ctypes.  The library lands in ``build/`` at the repository root, named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.  The build happens on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "kernel_library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # init, tpk, ts, alpha, asz, words, rows, mask, shift, ws, out,
    # n_strips, steps, vdd_ws, stream
    "mic_rans_decode_zzd": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P,
                            _I, _I, _I, _P],
    # init, w0, w1, w2, words, rows, mask, shift, escv, esides, erows, ws,
    # out, n_strips, steps, vdd_ws, fused, esc, stream
    "mic_rans_decode_alias": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                              _P, _I, _I, _I, _I, _I, _P],
    # ranks, te1, te2, aw, ar1, ar2, count, tls, out_w, out_f, out_x,
    # n_strips, steps, alias, stream
    "mic_rans_encode": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmic_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is missing; returns its path.
    nvcc's output (ptxas registers, shared memory and spills per kernel)
    is kept beside the library with the suffix ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(_CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        lib.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
