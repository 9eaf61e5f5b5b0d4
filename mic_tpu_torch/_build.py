"""Build and load the port's CUDA kernels and its C++ host tier.

``csrc/*.cu`` compile with nvcc, one process per source, all started
together, and link into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds), loaded with ctypes.  The
library lands in ``build/`` at the repository root, named by a hash of
the sources (headers included) and flags, so an edited source rebuilds
and an unchanged one loads the existing file.  The build happens on
first use.

``native/micfse.cpp``, the host tier, builds the same way with the host
compiler (``host_library``): no nvcc, CUDA or GPU, so the CPU tests run
it too.  Its name hashes the source, the flags, the compiler's version
and the instruction set ``-march=native`` selects, so a library built
for another CPU is never loaded.  A missing compiler or a failed compile
raises ``RuntimeError``; nothing falls back.
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

from . import trace

__all__ = ["build", "host_build", "host_compiler", "host_library", "host_program", "kernel_library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# mic_tpu/native/Makefile's flags (its plain -O3 build: the PGO pass needs
# the reference corpus)
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
_BUILT: set[Path] = set()  # the libraries and programs this process compiled

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
    # groups, teams, n_blocks, out, smem_bytes, stream
    "mic_lanes_decode_groups": [_P, _P, _I, _P, _I, _P],
    # groups, blocks, n_blocks, out, threads, lanes a thread, stream
    "mic_lanes_decode_wide": [_P, _P, _I, _P, _I, _I, _P],
    # wide, threads, lanes a thread, smem_bytes, out (int[3]: shared bytes a
    # block, blocks an SM, registers a thread)
    "mic_lanes_shape": [_I, _I, _I, _I, _P],
    # a0, a1, a2, o0, o1, o2, n, inverse, stream
    "mic_ycocgr": [_P, _P, _P, _P, _P, _P, _L, _I, _P],
    # x, out, rows, n, inverse, stream
    "mic_wt53_rows": [_P, _P, _L, _I, _I, _P],
    # groups, blocks, n_cmp, outs, strides, widths (host arrays), n_groups,
    # acc, stream
    "mic_mismatch_groups": [_P, _P, _I, _P, _P, _P, _I, _P, _P],
    # groups, blocks, n_blocks, ents, cols (host arrays), n_groups, out, runs,
    # flags, stream
    "mic_post_groups": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    # out (int[3]: shared bytes a block, blocks an SM, registers a thread)
    "mic_post_shape": [_P],
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


def library_path(defines: tuple = (), link: tuple = ()) -> Path:
    """Where the library for the current sources, flags, ``defines`` and
    ``link`` flags lives."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines, *link)).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmic_kernels-{h.hexdigest()[:16]}.so"


def build(defines: tuple = (), link: tuple = ()) -> Path:
    """Compile the sources if their library is missing; returns its path.
    ``defines`` are extra ``-DNAME=value`` flags (a library of its own:
    ``scripts/tans_design_points.py``, ``scripts/rle_design_points.py``,
    ``scripts/direct_design_points.py``, ``scripts/enc_design_points.py`` and
    ``scripts/lanes_design_points.py``
    build the kernels' other forms with them).  nvcc's output (ptxas
    registers, shared memory and spills per kernel) is kept beside the
    library with the suffix ``.log``.  ``link`` are extra flags of the
    link step (``scripts/profiler_records.py`` builds a library with
    ``-cudart shared``)."""
    lib = library_path(defines, link)
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
        cmd = [nvcc, *ARCH, *link, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
        if all(rc == 0 for _c, _o, rc in outs):
            res = subprocess.run(cmd, capture_output=True, text=True)
            outs.append((cmd, res.stdout + res.stderr, res.returncode))
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        lib.with_suffix(".log").write_text("".join(out for _c, out, _rc in outs))
        os.replace(os.path.join(tmp, "lib.so"), lib)  # atomic: a loader sees all or nothing
    _BUILT.add(lib)
    return lib


@functools.cache
def kernel_library(defines: tuple = (), link: tuple = ()) -> ctypes.CDLL:
    """The built kernel library with its C entry points declared; traced,
    a span ``lib.load`` (``built``: whether nvcc ran)."""
    with trace.span("lib.load", library="kernels") as sp:
        path = build(defines, link)
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        if sp is not None:
            sp.attrs["built"] = path in _BUILT
    return lib


_S = ctypes.c_size_t
_B = ctypes.c_char_p
_HOST_SIGNATURES = {
    # name: (restype, argtypes), mic_tpu/native/__init__.py's declarations
    "mic_read_ncount": (_S, [_B, _S, _P, _S, _P]),
    "mic_decompress_frame": (_I, [_B, _S, _I, _I, _I, _P]),
    "mic_compress_frame": (_S, [_P, _I, _I, ctypes.c_uint16, _I, _I, _P, _S]),
    "mic_entropy_compress": (_S, [_P, _S, _I, _P, _S]),
    "mic_entropy_decompress": (_S, [_B, _S, _P, _S]),
    "mic_native_version": (_I, []),
    "mic_normalize_write_count": (_S, [_P, ctypes.c_int64, _I, _I, _P, _P, _S]),
    "mic_lane_encode": (_S, [_P, _S, _I, _I, _P, _P, _P, _P, _P, _S]),
    "mic_compress_strips": (_S, [_P, _I, _I, ctypes.c_uint16, _I, _I, _I, _I, _P, _S]),
    "mic_decompress_strips": (_I, [_B, _S, _I, _P, _I]),
}


def host_compiler() -> str:
    """``$CXX`` where it is set, else ``c++`` or ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX")
    for c in ([cxx] if cxx else ["c++", "g++"]):
        path = shutil.which(c)
        if path:
            return path
    raise RuntimeError(f"no host C++ compiler: {'CXX=' + cxx if cxx else 'c++ and g++'} "
                       "not found; set CXX or put c++ on PATH")


def _run_checked(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if res.returncode:
        raise RuntimeError(f"host compiler failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def _host_output_path(source: str, name: str, cxx: str, flags: tuple) -> Path:
    """Where ``native/<source>`` built by ``cxx`` with ``flags`` lives:
    ``build/<name>`` with the hash before its suffix."""
    h = hashlib.sha256(" ".join((source, *flags)).encode())
    h.update(_run_checked([cxx, "--version"]).encode())
    # the instruction set -march=native stands for on this CPU
    h.update(_run_checked([cxx, *flags, "-dM", "-E", "-x", "c++", os.devnull]).encode())
    for src in sorted(_NATIVE.glob("*.cpp")):  # prof_encode.cpp includes micfse.cpp
        h.update(src.name.encode())
        h.update(src.read_bytes())
    stem, dot, suffix = name.partition(".")
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{dot}{suffix}"


def _host_build(source: str, name: str, flags: tuple) -> Path:
    cxx = host_compiler()
    out = _host_output_path(source, name, cxx, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        target = os.path.join(tmp, "out")
        log = _run_checked([cxx, *flags, "-o", target, str(_NATIVE / source)])
        out.with_name(out.name + ".log").write_text(f"{cxx} {' '.join(flags)}\n{log}")
        os.replace(target, out)  # atomic: a loader sees all or nothing
    _BUILT.add(out)
    return out


def host_build() -> Path:
    """Compile ``native/micfse.cpp`` into ``build/libmicfse-<hash>.so`` if
    that library is missing; returns its path."""
    return _host_build("micfse.cpp", "libmicfse.so", (*HOST_FLAGS, "-shared"))


def host_program() -> Path:
    """Compile ``native/prof_encode.cpp``, the native encode's stage
    profiler, into ``build/prof_encode-<hash>`` (``-DMIC_PROF_MAIN``) if
    it is missing; returns its path."""
    return _host_build("prof_encode.cpp", "prof_encode", (*HOST_FLAGS, "-DMIC_PROF_MAIN"))


@functools.cache
def host_library() -> ctypes.CDLL:
    """The host tier's library, built at first use, with every C entry
    point declared.  Raises ``RuntimeError`` where it cannot be built.
    Traced, a span ``lib.load`` (``built``: whether the compiler ran)."""
    with trace.span("lib.load", library="host") as sp:
        path = host_build()
        lib = ctypes.CDLL(str(path))
        for name, (res, args) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        if sp is not None:
            sp.attrs["built"] = path in _BUILT
    return lib
