"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with nvcc, one process per source, all started
together, and link into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds), loaded with ctypes.  The
library lands in ``build/`` at the repository root, named by a hash of
the sources (headers included) and flags, so an edited source rebuilds
and an unchanged one loads the existing file.  The build happens on
first use.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # groups, blocks, n_blocks, out, smem_bytes, stream
    "mic_direct_decode_groups": [_P, _P, _I, _P, _I, _P],
    # smem_bytes
    "mic_direct_occupancy": [_I],
    # groups, blocks, n_blocks, out, syms, st, tab_words, st_words, form,
    # stream
    "mic_rle_decode_groups": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    # ranks, te1, te2, aw, widths, ar1, ar2, count, tls, out_w, out_f,
    # out_x, n_strips, steps, alias, stream
    "mic_rans_encode": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _P],
    # aw, alias, out (int[3]: shared bytes a block, blocks an SM, threads)
    "mic_rans_encode_shape": [_I, _I, _P],
    # groups, wdesc, outs (host array of device pointers), n_groups, n_blocks,
    # warps, smem_bytes, stream
    "mic_tans_decode_groups": [_P, _P, _P, _I, _I, _I, _I, _P],
    # warps, smem_bytes
    "mic_tans_occupancy": [_I, _I],
    # a0, a1, a2, o0, o1, o2, n, inverse, stream
    "mic_ycocgr": [_P, _P, _P, _P, _P, _P, _L, _I, _P],
    # x, out, rows, n, inverse, stream
    "mic_wt53_rows": [_P, _P, _L, _I, _I, _P],
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


def library_path(defines: tuple = ()) -> Path:
    """Where the library for the current sources, flags and ``defines``
    lives."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmic_kernels-{h.hexdigest()[:16]}.so"


def build(defines: tuple = ()) -> Path:
    """Compile the sources if their library is missing; returns its path.
    ``defines`` are extra ``-DNAME=value`` flags (a library of its own:
    ``scripts/tans_design_points.py``, ``scripts/rle_design_points.py``,
    ``scripts/direct_design_points.py`` and ``scripts/enc_design_points.py``
    build the kernels' other forms with them).  nvcc's output (ptxas
    registers, shared memory and spills per kernel) is kept beside the
    library with the suffix ``.log``."""
    lib = library_path(defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(_CSRC.glob("*.cu")):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", objs[-1], str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        link = [nvcc, *ARCH, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
        if all(rc == 0 for _c, _o, rc in outs):
            res = subprocess.run(link, capture_output=True, text=True)
            outs.append((link, res.stdout + res.stderr, res.returncode))
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        lib.with_suffix(".log").write_text("".join(out for _c, out, _rc in outs))
        os.replace(os.path.join(tmp, "lib.so"), lib)  # atomic: a loader sees all or nothing
    return lib


@functools.cache
def kernel_library(defines: tuple = ()) -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = ctypes.CDLL(str(build(defines)))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
