"""Wide-lane rANS encode on the device, and the MICW device encoder.

Counterpart of ``mic_tpu.tpu.pallas_enc``, as ``rans_decode`` is of the
decode half of ``mic_tpu.tpu.pallas_rans``:

* ``magicu`` / ``build_enc_tables`` — the per-rank encode tables (the
  encoder's operands), carried over unchanged so their arrays are
  identical: ``te1 = (freq-1)<<18 | add<<17 | is1<<16 | cum<<4 | sh``,
  ``te2`` = the 32-bit division magic;
* ``rans_encode`` / ``rans_encode_alias`` — the wrappers of the encode
  kernel of ``csrc/rans_encode.cu`` in its FF 57 and FF 41 forms, each
  with a plain-PyTorch twin (``*_plain``) and a launch counter
  (``.launches``);
* ``stage_encode_batch`` / ``mict_encode_device_batch`` — many symbol
  streams into MICT blobs with one launch, byte-identical to the host
  encoder ``mic_tpu.tpu.device_rans.mict_encode``;
* ``MicwEncodePlan`` / ``micw_compress_device_many`` /
  ``micw_compress_device`` — MICW containers byte-identical to
  ``mic_tpu.tpu.strips.micw_compress`` with the same predictor and
  entropy, every candidate stream of every strip of every image encoded
  in at most two launches (one per entropy family).

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel or raises; nothing falls back to the
host encoder.  The sentinel errors (``IncompressibleError`` /
``UseRLEError``, alphabets over 4096) are per-stream format decisions
taken on the host before the launch, exactly as in ``pallas_enc``.

Operands travel as bit-views: ranks as int16 of the u16 ranks, tables
and counts as int32 of the u32 values.  The plain versions hold every
u32 quantity in int64 and mask with ``& 0xFFFFFFFF`` where the kernel's
u32 arithmetic wraps (torch has no uint32 arithmetic on the CPU).

Guards, taken identically by the kernel and the plain versions (valid
operands never reach them): a rank at or beyond the table width reads
zero table entries (freq 1, no division), and a logical shift by >= 32
gives 0, as ``jax.lax.shift_left`` does.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    histogram,
    optimal_table_log,
)

from .device_rans import (
    MICT_ALIAS_MAGIC,
    MICT_MAGIC,
    _alias_apply,
    _norm_and_header,
    alias_encode_plan,
    encode_tables,
)
from .rans_decode import _U32, _as_i16, _check, _u, to_device
from .strips import (
    ALIAS_TABLE_LOG,
    MAX_TABLE_LOG,
    STRIP_MODE_CONST,
    _micw_container,
    _rle_mid,
    _strip_candidates,
    _strip_layout,
    _strip_requests,
    _strip_select,
    _trials_for,
)

__all__ = [
    "magicu",
    "build_enc_tables",
    "rans_encode",
    "rans_encode_plain",
    "rans_encode_alias",
    "rans_encode_alias_plain",
    "mict_encode_device_batch",
    "MicwEncodePlan",
    "micw_compress_device",
    "micw_compress_device_many",
]

_MAX_TABLE_WIDTH = 4096  # alphabet cap of the device encode (12-bit rank)


# ---------------------------------------------------------------------------
# Encode tables
# ---------------------------------------------------------------------------


def magicu(d: int):
    """Unsigned magic number for division by d (Hacker's Delight 10-9):
    returns (M, add, sh) such that for all x < 2^32:
        t = mulhi32(x, M)
        q = (t >> sh)                     if add == 0
        q = ((t + ((x - t) >> 1)) >> sh)  if add == 1   (sh is post-fixup)
    equals x // d.  d == 1 is the caller's special case.
    """
    assert 2 <= d < 2**31
    p = 31
    nc = (2**32 // d) * d - 1
    while True:
        p += 1
        if 2**p > nc * (d - 1 - (2**p - 1) % d):
            m = (2**p + d - 1 - (2**p - 1) % d) // d
            break
    if m < 2**32:
        return m, 0, p - 32
    # 33-bit magic: keep the low 32 bits, use the add fixup; the shift
    # drops by one because the fixup halves.
    return m - 2**32, 1, p - 32 - 1


def _verify_magic(d, M, add, sh):
    for x in (0, 1, d - 1, d, d + 1, 2 * d - 1, 2**16, 2**31, 2**32 - 1,
              (2**32 // d) * d - 1, (2**32 // d) * d % 2**32):
        x &= 0xFFFFFFFF
        t = (x * M) >> 32
        q = (t >> sh) if add == 0 else ((t + ((x - t) >> 1)) >> sh)
        if q != x // d:
            return False
    return True


_MAGIC_CACHE: dict[int, tuple[int, int, int]] = {}


def _magic(d: int):
    got = _MAGIC_CACHE.get(d)
    if got is None:
        got = magicu(d)
        if not _verify_magic(d, *got):
            raise ArithmeticError(f"magicu: wrong magic for divisor {d}")
        _MAGIC_CACHE[d] = got
    return got


def build_enc_tables(parsed_norms, table_log: int):
    """Per-strip encode tables.

    parsed_norms: list of (freqs_by_rank u32[A], cums_by_rank u32[A]).
    Returns (te1, te2) uint32[S, asweep*128] and asweep.
    te1 = (freq-1)<<18 | add<<17 | is1<<16 | cum<<4 | sh;  te2 = magic M.
    """
    S = len(parsed_norms)
    amax = max(len(f) for f, _c in parsed_norms)
    asweep = max(1, (amax + 127) // 128)
    te1 = np.zeros((S, asweep * 128), np.uint32)
    te2 = np.zeros((S, asweep * 128), np.uint32)
    for i, (freqs, cums) in enumerate(parsed_norms):
        for r, (f, c) in enumerate(zip(freqs.tolist(), cums.tolist())):
            if f <= 0:
                raise ValueError("encode table: zero freq rank")
            if f == 1:
                M, add, sh, is1 = 0, 0, 0, 1
            else:
                M, add, sh = _magic(f)
                is1 = 0
            te1[i, r] = ((f - 1) << 18) | (add << 17) | (is1 << 16) | (c << 4) | sh
            te2[i, r] = M
    return te1, te2, asweep


# ---------------------------------------------------------------------------
# The encode kernel: wrappers and plain versions
# ---------------------------------------------------------------------------


def _operands(ranks, te1, te2, ar1, ar2, count, tls, steps, widths=None):
    S = ranks.shape[0] if isinstance(ranks, torch.Tensor) and ranks.dim() else 0
    if S == 0 or steps <= 0:
        raise ValueError("ranks must be [S>0, steps>0, 128]")
    dev = ranks.device
    aw = te1.shape[-1] if isinstance(te1, torch.Tensor) and te1.dim() == 2 else 0
    if not 0 < aw <= _MAX_TABLE_WIDTH:
        raise ValueError(f"te1/te2 must be [S, w] with w in 1..{_MAX_TABLE_WIDTH}")
    _check("ranks", ranks, (S, steps, 128), dev, torch.int16)
    named = [("te1", te1, (S, aw)), ("te2", te2, (S, aw)),
             ("count", count, (S, 128)), ("tls", tls, (S, 128))]
    if ar1 is not None:
        named += [("ar1", ar1, (S, 2, 128)), ("ar2", ar2, (S, 2, 128))]
    if widths is not None:
        named.append(("widths", widths, (S,)))
    for name, t, shape in named:
        _check(name, t, shape, dev)
    return S, aw


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """u32 shift left (wrapping); shifts >= 32 give 0."""
    return torch.where(s < 32, (x << s.clamp(max=31)) & _U32, torch.zeros_like(x))


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of ``v`` as an int32 bit-view."""
    return (((v & _U32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _encode_plain(ranks, te1, te2, ar1, ar2, count, tls, steps, widths=None):
    """Reverse-order rANS encode of every (strip, lane), one step of all
    lanes per iteration, from the last step to the first."""
    S, aw = _operands(ranks, te1, te2, ar1, ar2, count, tls, steps, widths)
    dev = ranks.device
    rk_all = ranks.to(torch.int64) & 0xFFFF
    te1, te2, tl = _u(te1), _u(te2), _u(tls)
    cnt = count.to(torch.int64)  # signed reading, as the kernel compares
    shift_rn = (32 - tl) & _U32
    # Each strip's table width: its own (at most aw), or aw.
    width = aw if widths is None else _u(widths).clamp(max=aw)[:, None]
    if ar1 is not None:
        starts, bases = _u(ar1).reshape(S, 256), _u(ar2).reshape(S, 256)
    lane = torch.arange(128, device=dev)
    x = torch.full((S, 128), 1 << 16, dtype=torch.int64, device=dev)
    words = torch.empty((S, steps, 128), dtype=torch.int16, device=dev)
    flags = torch.empty_like(words)
    for t in range(steps - 1, -1, -1):
        active = (t * 128 + lane) < cnt
        rk = rk_all[:, t]
        ok = rk < width
        idx = rk.clamp(max=aw - 1)
        e1 = torch.where(ok, torch.gather(te1, 1, idx), 0)
        e2 = torch.where(ok, torch.gather(te2, 1, idx), 0)
        f = (e1 >> 18) + 1
        add = (e1 >> 17) & 1
        is1 = (e1 >> 16) & 1
        c = (e1 >> 4) & 0xFFF
        sh = e1 & 0xF
        need = (x >= _shl(f, shift_rn)) & active
        w = torch.where(need, x & 0xFFFF, 0)
        x1 = torch.where(need, x >> 16, x)
        # q = x1 // f by the magic multiply: mulhi32(x1, M) from two
        # products that fit in int64, then the add/shift fix-up.
        t_hi = (x1 * (e2 >> 16) + ((x1 * (e2 & 0xFFFF)) >> 16)) >> 16
        q_add = ((t_hi + (((x1 - t_hi) & _U32) >> 1)) & _U32) >> sh
        q = torch.where(add == 1, q_add, t_hi >> sh)
        q = torch.where(is1 == 1, x1, q)
        rem = (x1 - q * f) & _U32
        if ar1 is None:
            x2 = (_shl(q, tl) + rem + c) & _U32
        else:
            # Standard slot -> alias slot: r = last run whose start <=
            # s_idx (9-round binary search over the 256 sorted starts,
            # pad 0xFFFFFFFF), slot = base[r] + (s_idx - start[r]).
            s_idx = (rem + c) & _U32
            n_le = torch.zeros_like(s_idx)
            step = 256
            while step:
                cand = n_le + step
                v = torch.gather(starts, 1, (cand - 1).clamp(max=255))
                n_le = torch.where((cand <= 256) & (v <= s_idx), cand, n_le)
                step >>= 1
            r = (n_le - 1).clamp(min=0)
            slot = torch.gather(bases, 1, r) + s_idx - torch.gather(starts, 1, r)
            x2 = (_shl(q, tl) + slot) & _U32
        x = torch.where(active, x2, x1)
        words[:, t] = _as_i16(w)
        flags[:, t] = need.to(torch.int16)
    return words, flags, _as_i32(x)


def _encode_launch(wrapper, ranks, te1, te2, ar1, ar2, count, tls, steps, widths=None,
                   lib=None):
    """One launch of the encode kernel; counts it on ``wrapper``.  ``lib``
    is another build of the kernel library (``scripts/enc_design_points.py``)."""
    S, aw = _operands(ranks, te1, te2, ar1, ar2, count, tls, steps, widths)
    if ranks.device.type != "cuda":
        raise ValueError(f"unsupported device {ranks.device}")
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    words = torch.empty((S, steps, 128), dtype=torch.int16, device=ranks.device)
    flags = torch.empty_like(words)
    states = torch.empty((S, 128), dtype=torch.int32, device=ranks.device)
    alias = ar1 is not None
    with torch.cuda.device(ranks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rans_encode(
            ranks.data_ptr(), te1.data_ptr(), te2.data_ptr(), aw,
            None if widths is None else widths.data_ptr(),
            ar1.data_ptr() if alias else None, ar2.data_ptr() if alias else None,
            count.data_ptr(), tls.data_ptr(), words.data_ptr(), flags.data_ptr(),
            states.data_ptr(), S, steps, int(alias), stream)
    if rc != 0:
        raise RuntimeError(f"mic_rans_encode launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return words, flags, states


def _launch_shape(aw: int, alias: bool, lib=None) -> tuple[int, int, int]:
    """The encode kernel's launch at table width ``aw``: (shared-memory
    bytes a block, blocks resident an SM, threads a block), from the CUDA
    occupancy query (``chip_smoke.py`` and ``scripts/enc_design_points.py``
    print it)."""
    import ctypes

    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    out = (ctypes.c_int * 3)()
    rc = lib.mic_rans_encode_shape(aw, int(alias), out)
    if rc != 0:
        raise RuntimeError(f"mic_rans_encode_shape failed: CUDA error {rc}")
    return tuple(out)


def rans_encode_plain(ranks, te1, te2, count, tls, *, steps: int, widths=None):
    """Plain-PyTorch twin of the FF 57 encode kernel (any device).  Same
    operands and outputs as :func:`rans_encode`."""
    return _encode_plain(ranks, te1, te2, None, None, count, tls, steps, widths)


def rans_encode(ranks, te1, te2, count, tls, *, steps: int, widths=None):
    """Encode rank streams into wide-lane rANS states and dense word
    planes (FF 57).

    ranks: int16 [S, steps, 128] (u16 rank of symbol ``t*128 + lane``,
    0 on pad lanes); te1/te2: int32 [S, w] (:func:`build_enc_tables`);
    count/tls: int32 [S, 128], each strip's symbol count and tableLog on
    every lane (mixed tableLogs share a launch); widths: None or int32
    [S], each strip's own table width (its alphabet; the kernel stages
    that many entries, and a rank at or past it, or past w, reads zero
    entries, as every rank past w does without it).  Returns (words int16
    [S, steps, 128], flags int16 [S, steps, 128], states int32
    [S, 128]): a stream's renorm words are ``words[flags != 0]`` in
    (step asc, lane asc) order and the final states are the decoder's
    initial states.  CPU tensors take the plain version; CUDA tensors
    launch the kernel of ``csrc/rans_encode.cu``.
    """
    if ranks.device.type == "cpu":
        return rans_encode_plain(ranks, te1, te2, count, tls, steps=steps, widths=widths)
    return _encode_launch(rans_encode, ranks, te1, te2, None, None, count, tls, steps, widths)


rans_encode.launches = 0


def rans_encode_alias_plain(ranks, te1, te2, ar1, ar2, count, tls, *, steps: int,
                            widths=None):
    """Plain-PyTorch twin of the FF 41 encode kernel (any device).  Same
    operands and outputs as :func:`rans_encode_alias`."""
    return _encode_plain(ranks, te1, te2, ar1, ar2, count, tls, steps, widths)


def rans_encode_alias(ranks, te1, te2, ar1, ar2, count, tls, *, steps: int, widths=None):
    """FF 41 form of :func:`rans_encode`: the same state machine, but the
    slot written is the alias permutation of cum + rem, resolved from
    the 256-entry run tables ar1 (standard-layout run starts, sorted,
    pad 0xFFFFFFFF) and ar2 (alias slot of each run's start), both int32
    [S, 2, 128].  The kernel reads the slot of cum + rem from a map it
    builds per strip from the run tables, and takes the tables' search
    where the map cannot answer (a slot past 2^min(tl, 12), starts not
    sorted, a map value past 16 bits), so both equal the search on any
    operands.  CPU tensors take the plain version; CUDA tensors launch
    the kernel of ``csrc/rans_encode.cu``."""
    if ranks.device.type == "cpu":
        return rans_encode_alias_plain(ranks, te1, te2, ar1, ar2, count, tls, steps=steps,
                                       widths=widths)
    return _encode_launch(rans_encode_alias, ranks, te1, te2, ar1, ar2, count, tls, steps,
                          widths)


rans_encode_alias.launches = 0


# ---------------------------------------------------------------------------
# MICT blobs: many streams, one launch
# ---------------------------------------------------------------------------


@dataclass
class StagedEncode:
    """Host half of a batch encode: the kernel's numpy operands (``ops``,
    in the wrapper's argument order), its step count, and per encodable
    stream (n, tl, header, ranks, esc_info), its position in the input
    and its table width (the wrappers' ``widths``)."""

    ops: tuple
    steps: int
    metas: list
    slot_of: list
    widths: np.ndarray  # each stream's alphabet: the entries its strip stages


def stage_encode_batch(streams, *, max_table_log: int = 12, on_error: str = "raise",
                       alias: bool = False) -> StagedEncode | None:
    """Histogram, normalization, ncount header, (alias) fold plan and
    rank streams of every stream, and the kernel operands of the whole
    batch; the normalization and header are the C++ tier's
    (``device_rans._norm_and_header``), as in ``mic_tpu``.  Streams that raise a sentinel error are skipped with
    ``on_error="none"``; returns None when none is left.  The host half
    of :func:`mict_encode_device_batch`, public only so that tests and
    ``chip_smoke.py`` can time it and build kernel operands with it."""
    specs, metas, runs, slot_of = [], [], [], []
    for si, symbols in enumerate(streams):
        try:
            symbols = np.asarray(symbols, dtype=np.uint16)
            n = len(symbols)
            if n == 0:
                raise IncompressibleError
            counts, max_count, symbol_len = histogram(symbols)
            if max_count == n:
                raise UseRLEError
            if max_count == 1 or max_count < (n >> 15):
                raise IncompressibleError
            esc_info = None
            if alias:
                kept_vals, esc_val, tl, header, freq, cumul, al = (
                    alias_encode_plan(counts, symbol_len, n, DEFAULT_TABLE_LOG,
                                      max_table_log))
                recoded, esc_values = _alias_apply(symbols, kept_vals, esc_val)
                symbols = recoded.astype(np.uint16)
                esc_info = (esc_val, esc_values)
                run_se = al["enc_runs"]
            else:
                tl = optimal_table_log(DEFAULT_TABLE_LOG, n, symbol_len)
                tl = min(tl, max_table_log)
                try:
                    norm, header = _norm_and_header(counts, n, tl, symbol_len)
                    freq, cumul = encode_tables(norm, tl)
                except ValueError as e:
                    raise IncompressibleError(str(e)) from e
                run_se = None
            alphabet = np.nonzero(freq)[0]
            if len(alphabet) > _MAX_TABLE_WIDTH:
                raise IncompressibleError("alphabet too wide for device encode")
        except (IncompressibleError, UseRLEError):
            if on_error == "raise":
                raise
            continue
        lut = np.zeros(65536, np.uint16)
        lut[alphabet] = np.arange(len(alphabet), dtype=np.uint16)
        specs.append((freq[alphabet].astype(np.uint32), cumul[alphabet].astype(np.uint32)))
        metas.append((n, tl, header, lut[symbols], esc_info))
        runs.append(run_se)
        slot_of.append(si)
    if not specs:
        return None

    S = len(specs)
    # No rounding of the step count: the TPU kernel's 8-step blocks and
    # strip groups have no counterpart here.
    steps = max(-(-m[0] // 128) for m in metas)
    te1, te2, _asweep = build_enc_tables(specs, max(m[1] for m in metas))
    rk = np.zeros((S, steps * 128), np.uint16)
    cnt = np.zeros((S, 128), np.uint32)
    tls = np.zeros((S, 128), np.uint32)
    for i, (n, tl_i, _h, ranks, _e) in enumerate(metas):
        rk[i, :n] = ranks
        cnt[i, :] = n
        tls[i, :] = tl_i
    rk = rk.reshape(S, steps, 128)
    if alias:
        ar1 = np.full((S, 256), 0xFFFFFFFF, np.uint32)
        ar2 = np.zeros((S, 256), np.uint32)
        for i, (starts, bases) in enumerate(runs):
            ar1[i, : len(starts)] = starts
            ar2[i, : len(bases)] = bases
        ops = (rk, te1, te2, ar1.reshape(S, 2, 128), ar2.reshape(S, 2, 128), cnt, tls)
    else:
        ops = (rk, te1, te2, cnt, tls)
    widths = np.array([len(f) for f, _c in specs], np.int32)
    return StagedEncode(ops, steps, metas, slot_of, widths)


def staged_to_device(staged: StagedEncode, device) -> tuple[torch.Tensor, ...]:
    """The staged numpy operands as bit-view tensors on ``device`` (for
    tests and measurement, like :func:`stage_encode_batch`)."""
    rk = torch.from_numpy(staged.ops[0].view(np.int16)).to(device)
    return (rk, *to_device(staged.ops[1:], device))


def mict_encode_device_batch(streams, device, max_table_log: int = 12,
                             on_error: str = "raise", alias: bool = False,
                             max_bytes: list | None = None):
    """Encode many u16 symbol streams into MICT blobs with ONE launch of
    the encode kernel on ``device``.  Blobs are byte-identical to
    ``mic_tpu.tpu.device_rans.mict_encode(stream, lanes=128,
    max_table_log=max_table_log)`` (``alias=True``: to
    ``mict_encode_alias``, the FF 41 variant).

    Returns a list of bytes.  Raises the host encoder's sentinel errors
    per stream; alphabets over 4096 raise IncompressibleError.  With
    ``on_error="none"`` failing streams yield None instead.  ``max_bytes``
    gives a per-stream byte budget (default: the stream's raw size);
    blobs at or over it fail like any sentinel error.

    The words leave the card compacted: one ``masked_select`` of the
    dense word plane by its flags gives every stream's words back to
    back in (step, lane) order, the decoder's order, and the per-strip
    flag counts split them.
    """
    failed = [None] * len(streams)
    staged = stage_encode_batch(streams, max_table_log=max_table_log,
                                on_error=on_error, alias=alias)
    if staged is None:
        return failed
    ops = staged_to_device(staged, device)
    fn = rans_encode_alias if alias else rans_encode
    widths = torch.from_numpy(staged.widths).to(device)
    w, f, x = fn(*ops, steps=staged.steps, widths=widths)
    nz = f != 0
    sel = torch.masked_select(w, nz).cpu().numpy().view(np.uint16)
    ends = np.cumsum(nz.sum((1, 2)).cpu().numpy())
    states = x.cpu().numpy().view(np.uint32)

    blobs = list(failed)
    for i, (n, tl, header, _ranks, esc_info) in enumerate(staged.metas):
        words = sel[ends[i - 1] if i else 0 : ends[i]]
        out = bytearray()
        if alias:
            esc_val, esc_values = esc_info
            out += MICT_ALIAS_MAGIC
            out += struct.pack("<BB", 7, tl)
            out += struct.pack("<II", n, len(words))
            out += struct.pack("<IH", len(esc_values), esc_val)
        else:
            out += MICT_MAGIC
            out += struct.pack("<BB", 7, tl)
            out += struct.pack("<II", n, len(words))
        out += header
        out += states[i].astype("<u4").tobytes()
        out += words.astype("<u2").tobytes()
        if alias:
            out += esc_info[1].astype("<u2").tobytes()
        si = staged.slot_of[i]
        budget = n * 2
        if max_bytes is not None and max_bytes[si] is not None:
            budget = max_bytes[si]
        if len(out) >= budget:
            if on_error == "raise":
                raise IncompressibleError
            continue
        blobs[si] = bytes(out)
    return blobs


# ---------------------------------------------------------------------------
# MICW containers
# ---------------------------------------------------------------------------


class MicwEncodePlan:
    """A device encode of a batch of images into MICW containers, in its
    three stages: candidate generation on the host (here, in the
    constructor), the device encode of every requested candidate stream
    (:meth:`encode`, at most two launches) and the per-strip selection
    plus container assembly on the host (:meth:`assemble`).

    ``images`` is a list of (pixels, width, height, max_value
    [, num_strips]).  Candidate generation and selection are the same
    code as the host encoder's (``_strip_candidates`` /
    ``_strip_select``); the plan pre-encodes every (candidate, family)
    pair the selection may ask for (``_strip_requests``), each with the
    strip's raw size as its byte budget.
    """

    def __init__(self, images, entropy: str = "standard", predictor: str = "zzd"):
        if entropy not in ("standard", "alias", "best"):
            raise ValueError(f"micw device encode: unknown entropy {entropy!r}")
        self.entropy, self.predictor = entropy, predictor
        self.trials = _trials_for(predictor)
        self.images = []  # (width, height, max_value, strip_h, entries, band)
        self.jobs = {False: [], True: []}  # alias? -> [(syms, max_bytes)]
        for spec in images:
            pixels, width, height, max_value = spec[:4]
            pixels, width, height, actual, strip_h, band = _strip_layout(
                pixels, width, height, spec[4] if len(spec) > 4 else 0)
            mid = _rle_mid(max_value)
            entries = []
            for s in range(actual):
                y0 = s * strip_h
                y1 = min(y0 + strip_h, height)
                strip_px = pixels[y0 * width : y1 * width]
                if strip_px[0] == strip_px.max() and strip_px[0] == strip_px.min():
                    entries.append(("const", strip_px))
                    continue
                candidates = _strip_candidates(strip_px, width, y1 - y0, max_value,
                                               mid, self.trials, entropy)
                slots = {}
                for i, alias in _strip_requests(candidates, len(self.trials), entropy):
                    self.jobs[alias].append((candidates[i][1], strip_px.nbytes))
                    slots[(i, alias)] = len(self.jobs[alias]) - 1
                entries.append(("enc", strip_px, candidates, slots))
            self.images.append((width, height, max_value, strip_h, entries, band))

    def encode(self, device) -> dict:
        """Device-encode every requested stream: {alias?: [blob or None]},
        one launch per non-empty family."""
        return {
            alias: (mict_encode_device_batch(
                [j[0] for j in batch], device, on_error="none", alias=alias,
                max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG,
                max_bytes=[j[1] for j in batch],
            ) if batch else [])
            for alias, batch in self.jobs.items()
        }

    def assemble(self, results: dict) -> list[bytes]:
        """Select each strip's blob from ``results`` and write the
        containers, image order."""
        outs = []
        for (width, height, max_value, strip_h, entries, band) in self.images:
            blobs, metas = [], []
            for entry in entries:
                if entry[0] == "const":
                    blobs.append(entry[1][:1].astype("<u2").tobytes())
                    metas.append((0, 0, 0, 0, STRIP_MODE_CONST))
                    continue
                _tag, strip_px, candidates, slots = entry

                def enc(i, alias, _slots=slots):
                    # Direct indexing: a pair the requests missed must
                    # KeyError, not silently diverge from the host.
                    return results[alias][_slots[(i, alias)]]

                blob, meta = _strip_select(candidates, strip_px, len(self.trials),
                                           self.entropy, enc)
                blobs.append(blob)
                metas.append(meta)
            outs.append(_micw_container(width, height, strip_h, max_value, self.predictor,
                                        band, blobs, metas))
        return outs


def micw_compress_device_many(images, device, entropy: str = "standard",
                              predictor: str = "zzd") -> list[bytes]:
    """Device-encode many images into MICW containers on ``device``.

    ``images`` is a list of (pixels, width, height, max_value
    [, num_strips]); returns the containers in image order, each
    byte-identical to ``mic_tpu.tpu.strips.micw_compress`` on that image
    with the same ``predictor`` / ``entropy``, for every trial set
    ("auto-fast", "auto-r", "auto", a fixed predictor) and
    ``entropy="best"``.  Every candidate of every strip of every image
    is encoded in at most two launches, one per entropy family."""
    plan = MicwEncodePlan(images, entropy, predictor)
    return plan.assemble(plan.encode(device))


def micw_compress_device(pixels, width: int, height: int, max_value: int, device,
                         num_strips: int = 0, entropy: str = "standard",
                         predictor: str = "zzd") -> bytes:
    """One image through :func:`micw_compress_device_many`."""
    return micw_compress_device_many(
        [(pixels, width, height, max_value, num_strips)], device,
        entropy=entropy, predictor=predictor)[0]
