"""rANS decode kernels of MICW: the fused direct modes (zzd / vdd / pdd),
the fused r-modes (zzr / vdr / pdr) and the symbols-out forms the post
path (``post.py``) decodes the other strips with.

Counterpart of the decode half of ``mic_tpu.tpu.pallas_rans``:

* ``build_packed_tables`` / ``build_pallas_tables`` /
  ``build_alias_bucket_tables`` — the numpy operand builders, carried
  over unchanged so their arrays are identical (pinned by
  ``tests/test_torch_host_format.py`` and ``tests/test_torch_post_decode.py``);
* ``to_device`` — numpy ``uint32`` operands to int32 bit-view tensors;
* ``rans_decode_zzd`` / ``rans_decode_alias`` — the wrappers of the two
  direct-mode CUDA kernels in ``csrc/rans_decode.cu`` (``fused=False``
  gives the alias symbols);
* ``rans_decode_packed`` / ``rans_decode`` — the symbols-out FF 57 kernels
  of ``csrc/rans_decode.cu``: packed tables (tableLog <= 12, alphabets
  <= 4096) and two tables (tableLog up to 16, any alphabet);
* ``rans_decode_rle`` / ``rans_decode_rle_alias`` — one bucket of the
  fused r-mode kernel in ``csrc/rans_rle.cu`` (either entropy front end,
  then the SoA-RLE expand and the direct inverse), and
  ``rans_decode_rle_groups`` — many buckets, both front ends, in one
  launch (:class:`RlePacking` lays them out);

each with a plain-PyTorch twin (``*_plain``) and a launch counter
(``.launches``).

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel or raises.

Torch has no uint32 arithmetic on the CPU, so operands travel as int32
bit-views of the builders' ``uint32`` arrays and the plain versions hold
every u32 quantity in int64, masking with ``& 0xFFFFFFFF`` where the
kernel's u32 arithmetic wraps.  Outputs are int16 bit-views of the u16
symbols or pixels (``.numpy().view(np.uint16)`` at the numpy boundary).

Out-of-range guards, taken identically by the kernels and the plain
versions (valid operands never reach them): a logical shift by >= 32
gives 0, as ``jax.lax.shift_right_logical`` does; a packed-table slot or
rank beyond its table reads 0, as the Pallas sweep does; an alias bucket
index clamps to 127; the renorm word window's first row clamps to
``rows - 2`` and the escape cursor to ``rows * 128 - 256``, as the
Pallas kernels' dynamic slices do.  The r-kernels add: a decoded symbol
keeps its low 16 bits (the builders' side streams are u16); ``nrun``
clamps to [0, maxr] and ``nsame`` to [0, steps * 128]; the run-length and
literal-length carries saturate at 2^29; the same-value and literal
reads go through the Pallas kernel's 256-symbol windows (first row
clamped to [0, steps - 2], offset to [0, 255]) and the literal cursor
clamps to ``steps * 128 - 1``, as in ``_expand_rle_phase``; the run search
reads no table entry past ``maxr - 1``.  The run search itself is a
binary search over a window of 32 (``dense``) or 256 runs from the run
holding the row's first pixel, where the Pallas kernel counts starts in
a 32-candidate or a 384-entry window: on every honest stream both find
the run holding each pixel, and on a dishonest one (a FLAG_RDENSE that
lies, zero-length runs) they may decode different garbage.  The CUDA
r-kernel expands a strip in parallel only where :func:`rle_honest` shows
that the parallel walk finds the runs this windowed search finds; every
other strip takes the serial search, so the kernel equals the plain twin
on every input.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_rans import alias_construct, slot_tables

__all__ = [
    "build_packed_tables",
    "build_pallas_tables",
    "build_alias_bucket_tables",
    "to_device",
    "rans_decode_zzd",
    "rans_decode_zzd_plain",
    "rans_decode_packed",
    "rans_decode_packed_plain",
    "rans_decode",
    "rans_decode_plain",
    "rans_decode_alias",
    "rans_decode_alias_plain",
    "rans_decode_rle",
    "rans_decode_rle_plain",
    "rans_decode_rle_alias",
    "rans_decode_rle_alias_plain",
    "rans_decode_rle_groups",
    "rans_decode_rle_groups_plain",
    "RlePacking",
    "rle_honest",
]

_U32 = 0xFFFFFFFF
_VDD_WS = (0, 1, 2, 4, 8)


def build_packed_tables(parsed, table_log: int, min_steps: int = 0):
    """Packed-kernel table build; returns None if any strip's tableLog
    exceeds 12 or alphabet exceeds 4096 symbols.  Otherwise returns
    (init, tpk, alpha, words, mask, shift, counts, steps, asweep)
    with tpk[slot] = bias<<12 | rank and alpha[rank] = (freq-1)<<16 | sym.
    ``min_steps`` pads the scan length (and the word-stream margins that
    depend on it) up to a caller-chosen bucket size."""
    S = len(parsed)
    if table_log > 12:
        return None
    TS = 1 << table_log
    init = np.zeros((S, 128), np.uint32)
    tpk = np.zeros((S, TS), np.uint32)
    steps = max(min_steps, max((p[2] + 127) // 128 for p in parsed))
    steps = (steps + 7) // 8 * 8  # kernel stores 8-step blocks
    # Margin: a shorter strip keeps renorming garbage states off the zero
    # padding after its stream ends, for (steps*128 - count) lane-steps.
    margin = max(steps * 128 - p[2] for p in parsed) + 256
    wmax = ((max(len(p[4]) for p in parsed) + margin + 127) // 128) * 128
    words = np.zeros((S, wmax), np.uint32)
    mask = np.zeros((S, 128), np.uint32)
    shift = np.zeros((S, 128), np.uint32)
    counts = []
    alphas = []
    for i, p in enumerate(parsed):
        L, tl, count, states, wrds, norm, _sl, alias = p
        if L != 128:
            raise ValueError("pallas rANS kernel requires 128 lanes per strip")
        norm = np.asarray(norm)
        alpha_syms = np.nonzero(norm)[0].astype(np.uint32)
        if len(alpha_syms) > 4096:
            return None
        sym, fs, bs, _, _ = slot_tables(norm, tl, alias)
        rank = np.searchsorted(alpha_syms, sym).astype(np.uint32)
        packed = (bs.astype(np.uint32) << 12) | rank
        reps = TS // (1 << tl)
        tpk[i] = np.tile(packed, reps)
        init[i] = states
        words[i, : len(wrds)] = wrds
        mask[i, :] = (1 << tl) - 1
        shift[i, :] = tl
        counts.append(count)
        fr = norm[alpha_syms].copy()
        fr[fr < 0] = 1  # low-prob (-1) symbols decode with freq 1
        alphas.append(((fr.astype(np.uint32) - 1) << 16) | alpha_syms)
    asweep = max(1, (max(len(a) for a in alphas) + 127) // 128)
    p2 = 1
    while p2 < asweep:
        p2 *= 2
    asweep = p2
    alpha = np.zeros((S, asweep * 128), np.uint32)
    for i, a in enumerate(alphas):
        alpha[i, : len(a)] = a
    words = words.reshape(S, -1, 128)
    return init, tpk, alpha, words, mask, shift, counts, steps, asweep


def build_pallas_tables(parsed, table_log: int, min_steps: int = 0):
    """Two-table build for FF 57 strips of any tableLog and alphabet.
    Returns (init, tsym, tfb, words, mask, shift, counts, steps) with
    tsym[slot] = sym and tfb[slot] = freq<<16 | bias; strips with smaller
    tableLogs get their tables tiled up to 2^table_log (their slot masks
    stay their own).  ``min_steps`` pads the scan length like
    build_packed_tables."""
    S = len(parsed)
    TS = 1 << table_log
    init = np.zeros((S, 128), np.uint32)
    tsym = np.zeros((S, TS), np.uint32)
    tfb = np.zeros((S, TS), np.uint32)
    steps = max(min_steps, max((p[2] + 127) // 128 for p in parsed))
    steps = (steps + 7) // 8 * 8
    # See build_packed_tables: margin covers garbage-state renorms on the
    # zero padding after a short strip's stream ends.
    margin = max(steps * 128 - p[2] for p in parsed) + 256
    wmax = ((max(len(p[4]) for p in parsed) + margin + 127) // 128) * 128
    words = np.zeros((S, wmax), np.uint32)
    mask = np.zeros((S, 128), np.uint32)
    shift = np.zeros((S, 128), np.uint32)
    counts = []
    for i, p in enumerate(parsed):
        L, tl, count, states, wrds, norm, _sl, alias = p
        if L != 128:
            raise ValueError("pallas rANS kernel requires 128 lanes per strip")
        sym, fs, bs, _, _ = slot_tables(norm, tl, alias)
        reps = TS // (1 << tl)
        tsym[i] = np.tile(sym.astype(np.uint32), reps)
        tfb[i] = np.tile((fs.astype(np.uint32) << 16) | bs.astype(np.uint32), reps)
        init[i] = states
        words[i, : len(wrds)] = wrds
        mask[i, :] = (1 << tl) - 1
        shift[i, :] = tl
        counts.append(count)
    words = words.reshape(S, -1, 128)
    return init, tsym, tfb, words, mask, shift, counts, steps


def build_alias_bucket_tables(parsed, min_steps: int = 0):
    """Bucket-table build for alias-mapped strips (mict_parse outputs
    whose ``alias`` element is a (esc_val, esc_values) tuple).  Returns
    (init, w0, w1, w2, words, mask, shift, escv, esides, counts, steps).
    ``min_steps`` pads the scan length like build_packed_tables."""
    S = len(parsed)
    init = np.zeros((S, 128), np.uint32)
    w0 = np.zeros((S, 128), np.uint32)
    w1 = np.zeros((S, 128), np.uint32)
    w2 = np.zeros((S, 128), np.uint32)
    steps = max(min_steps, max((p[2] + 127) // 128 for p in parsed))
    steps = (steps + 7) // 8 * 8
    margin = max(steps * 128 - p[2] for p in parsed) + 256
    wmax = ((max(len(p[4]) for p in parsed) + margin + 127) // 128) * 128
    words = np.zeros((S, wmax), np.uint32)
    mask = np.zeros((S, 128), np.uint32)
    shift = np.zeros((S, 128), np.uint32)
    escv = np.full((S, 128), 0xFFFFFFFF, np.uint32)
    # Side-stream margin: pad-step escape reads clamp in-kernel, so the
    # allocation only needs the clamp headroom (384 >= 256 + window).
    emax = ((max(len(p[7][1]) for p in parsed) + 384 + 127) // 128) * 128
    esides = np.zeros((S, emax), np.uint32)
    counts = []
    for i, p in enumerate(parsed):
        L, tl, count, states, wrds, norm, _sl, alias = p
        if L != 128:
            raise ValueError("alias kernel requires 128 lanes per strip")
        if tl > 12:
            # (freq-1)/sbp/sba overflow their 12-bit w1/w2 fields.
            raise ValueError("alias kernel requires tableLog <= 12")
        if alias is None:
            raise ValueError("build_alias_bucket_tables: standard-magic strip")
        al = alias_construct(norm, tl)
        w0[i] = (al["p"] << 16) | al["a"]
        w1[i] = (al["t"] << 24) | ((al["fp"] - 1) << 12) | al["sbp"]
        w2[i] = ((al["fa"] - 1) << 12) | al["sba"]
        init[i] = states
        words[i, : len(wrds)] = wrds
        mask[i, :] = (1 << tl) - 1
        shift[i, :] = tl
        esc_val, esc_values = alias
        if len(esc_values):
            escv[i, :] = esc_val
            esides[i, : len(esc_values)] = esc_values
        counts.append(count)
    words = words.reshape(S, -1, 128)
    esides = esides.reshape(S, -1, 128)
    return init, w0, w1, w2, words, mask, shift, escv, esides, counts, steps


def to_device(arrays, device) -> tuple[torch.Tensor, ...]:
    """Numpy ``uint32`` operands -> contiguous int32 bit-view tensors on
    ``device`` (torch has no uint32 arithmetic on the CPU)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a, dtype=np.uint32)
        out.append(torch.from_numpy(a.view(np.int32)).to(device))
    return tuple(out)


# ---------------------------------------------------------------------------
# Shared checks and plain-PyTorch building blocks
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.int32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} (unsigned bit-view), got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_steps(steps: int, vdd_ws: int):
    if steps <= 0 or steps % 8:
        raise ValueError(f"steps must be a positive multiple of 8, got {steps}")
    if vdd_ws not in _VDD_WS:
        raise ValueError(f"vdd_ws must be one of {_VDD_WS}, got {vdd_ws}")


def _u(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> its uint32 value in int64."""
    return t.to(torch.int64) & _U32


def _shr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical u32 shift right; shifts >= 32 give 0."""
    return torch.where(s < 32, x >> s.clamp(max=31), torch.zeros_like(x))


def _as_i16(v: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of ``v`` as an int16 bit-view."""
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _renorm(xn, cur, words, rows):
    """Lanes whose state fell below 2^16 pull the next words of their
    strip's stream, in lane order (exclusive prefix sum over the need
    mask).  Returns the new states and cursors."""
    need = xn < (1 << 16)
    n = need.to(torch.int64)
    k = torch.cumsum(n, dim=1) - n
    row = torch.clamp(cur >> 7, max=rows - 2)
    wv = torch.gather(words, 1, row * 128 + (cur & 127) + k)
    x = torch.where(need, ((xn << 16) | wv) & _U32, xn)
    return x, cur + n.sum(dim=1, keepdim=True)


class _Inverse:
    """The direct predictors' inverse fused into both kernels: unzigzag,
    then either the row prefix sum with its per-strip row reset every
    ``ws`` steps (zzd, and pdd's first pass) or the previous-row carry
    of ``vdd_ws`` 128-lane chunks (vdd)."""

    def __init__(self, S, vdd_ws, ws, device):
        self.vdd_ws = vdd_ws
        self.ws = ws[:, :1].to(torch.int64)  # int32 view, as the kernel reads it
        self.rowc = torch.zeros((S, max(vdd_ws, 1), 128 if vdd_ws else 1),
                                dtype=torch.int64, device=device)
        self.rcnt = torch.zeros((S, 1), dtype=torch.int64, device=device)

    def __call__(self, t: int, sym: torch.Tensor) -> torch.Tensor:
        si = ((sym & _U32) ^ 0x80000000) - 0x80000000  # int32 reading of the u32
        dz = (si >> 1) ^ (-(si & 1))
        if self.vdd_ws:
            col = t % self.vdd_ws
            pix = (self.rowc[:, col] + dz) & 0xFFFF
            self.rowc[:, col] = pix
            return pix
        rowc = torch.where(self.rcnt == 0, 0, self.rowc[:, 0])
        pix = (rowc + torch.cumsum(dz, dim=1)) & 0xFFFF
        self.rowc[:, 0] = pix[:, 127:]
        self.rcnt = self.rcnt + 1
        self.rcnt = torch.where(self.rcnt >= self.ws, 0, self.rcnt)
        return pix


# ---------------------------------------------------------------------------
# FF 57 packed-table kernel
# ---------------------------------------------------------------------------


def _table_operands(init, tables, words, mask, shift, steps, vdd_ws=0):
    """Checks of the operands every FF 57 wrapper takes; ``tables`` is
    ((name, tensor, max width), ...).  Returns S, the table widths and
    the word rows."""
    _check_steps(steps, vdd_ws)
    S = init.shape[0]
    dev = init.device
    if S == 0 or init.dim() != 2 or words.dim() != 3:
        raise ValueError("init must be [S>0, 128] and words [S, rows, 128]")
    rows = words.shape[1]
    if rows < 2:
        raise ValueError(f"words must have >= 2 rows ({rows})")
    widths = []
    for name, t, most in tables:
        w = t.shape[-1] if isinstance(t, torch.Tensor) and t.dim() == 2 else 0
        if not 0 < w <= most:
            raise ValueError(f"{name} width {w} must be in 1..{most}")
        _check(name, t, (S, w), dev)
        widths.append(w)
    for name, t, shape in (("init", init, (S, 128)), ("words", words, (S, rows, 128)),
                           ("mask", mask, (S, 128)), ("shift", shift, (S, 128))):
        _check(name, t, shape, dev)
    return S, *widths, rows


def _packed_operands(init, tpk, alpha, words, mask, shift, steps, vdd_ws=0):
    return _table_operands(init, (("tpk", tpk, 4096), ("alpha", alpha, 4096)), words,
                           mask, shift, steps, vdd_ws)


def _zzd_operands(init, tpk, alpha, words, mask, shift, ws, steps, vdd_ws):
    out = _packed_operands(init, tpk, alpha, words, mask, shift, steps, vdd_ws)
    _check("ws", ws, (out[0], 128), init.device)
    return out


def _packed_symbols(init, tpk, alpha, words, mask, shift, steps):
    """The packed-table decode's symbols, one [S, 128] int64 tensor per
    step (the plain version of ``PackedFront`` in ``csrc/rans_common.cuh``)."""
    S, ts, asz, rows = init.shape[0], tpk.shape[-1], alpha.shape[-1], words.shape[1]
    x = _u(init)
    tpk, alpha, m, sft = _u(tpk), _u(alpha), _u(mask), _u(shift)
    words = _u(words).reshape(S, -1)
    cur = torch.zeros((S, 1), dtype=torch.int64, device=init.device)
    for _t in range(steps):
        slot = x & m
        pk = torch.where(slot < ts, torch.gather(tpk, 1, slot.clamp(max=ts - 1)), 0)
        rank = pk & 0xFFF
        av = torch.where(rank < asz, torch.gather(alpha, 1, rank.clamp(max=asz - 1)), 0)
        xn = (((av >> 16) + 1) * _shr(x, sft) + (pk >> 12)) & _U32
        x, cur = _renorm(xn, cur, words, rows)
        yield av & 0xFFFF


def rans_decode_zzd_plain(init, tpk, alpha, words, mask, shift, ws, *,
                          steps: int, vdd_ws: int = 0) -> torch.Tensor:
    """Plain-PyTorch twin of the zzd kernel (any device).  Same operands
    and output as :func:`rans_decode_zzd`."""
    S = _zzd_operands(init, tpk, alpha, words, mask, shift, ws, steps, vdd_ws)[0]
    inverse = _Inverse(S, vdd_ws, ws, init.device)
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    for t, sym in enumerate(_packed_symbols(init, tpk, alpha, words, mask, shift, steps)):
        out[:, t] = _as_i16(inverse(t, sym))
    return out


def rans_decode_zzd(init, tpk, alpha, words, mask, shift, ws, *,
                    steps: int, vdd_ws: int = 0) -> torch.Tensor:
    """Fused MICW decode of FF 57 strips: packed-table rANS + unzigzag +
    the zzd row prefix sum (``vdd_ws == 0``) or the vdd previous-row
    carry (``vdd_ws`` = width/128 in {1, 2, 4, 8}).

    Operands are int32 bit-views (:func:`to_device`) of
    :func:`build_packed_tables`' arrays plus ``ws`` [S, 128], each
    strip's row width in 128-lane steps.  Returns int16 [S, steps, 128]
    (bit-view of u16 pixels).  CPU tensors take the plain version; CUDA
    tensors launch the kernel of ``csrc/rans_decode.cu``.
    """
    S, ts, asz, rows = _zzd_operands(init, tpk, alpha, words, mask, shift,
                                     ws, steps, vdd_ws)
    if init.device.type == "cpu":
        return rans_decode_zzd_plain(init, tpk, alpha, words, mask, shift, ws,
                                     steps=steps, vdd_ws=vdd_ws)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    from .._build import kernel_library

    lib = kernel_library()
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rans_decode_zzd(
            init.data_ptr(), tpk.data_ptr(), ts, alpha.data_ptr(), asz,
            words.data_ptr(), rows, mask.data_ptr(), shift.data_ptr(),
            ws.data_ptr(), out.data_ptr(), S, steps, vdd_ws, stream)
    if rc != 0:
        raise RuntimeError(f"mic_rans_decode_zzd launch failed: CUDA error {rc}")
    rans_decode_zzd.launches += 1
    return out


rans_decode_zzd.launches = 0


def rans_decode_packed_plain(init, tpk, alpha, words, mask, shift, *,
                             steps: int) -> torch.Tensor:
    """Plain-PyTorch twin of the symbols-out packed kernel (any device).
    Same operands and output as :func:`rans_decode_packed`."""
    S = _packed_operands(init, tpk, alpha, words, mask, shift, steps)[0]
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    for t, sym in enumerate(_packed_symbols(init, tpk, alpha, words, mask, shift, steps)):
        out[:, t] = _as_i16(sym)
    return out


def rans_decode_packed(init, tpk, alpha, words, mask, shift, *, steps: int) -> torch.Tensor:
    """FF 57 packed-table rANS decode of S strips, symbols out (the
    entropy stage of the post path).

    Operands are int32 bit-views (:func:`to_device`) of
    :func:`build_packed_tables`' first six arrays.  Returns int16 [S,
    steps, 128] (bit-view of the u16 symbols, in stream order per strip;
    steps past a short strip's end decode the zero padding).  CPU tensors
    take the plain version; CUDA tensors launch the kernel of
    ``csrc/rans_decode.cu``.
    """
    S, ts, asz, rows = _packed_operands(init, tpk, alpha, words, mask, shift, steps)
    if init.device.type == "cpu":
        return rans_decode_packed_plain(init, tpk, alpha, words, mask, shift, steps=steps)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    from .._build import kernel_library

    lib = kernel_library()
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rans_decode_packed(
            init.data_ptr(), tpk.data_ptr(), ts, alpha.data_ptr(), asz,
            words.data_ptr(), rows, mask.data_ptr(), shift.data_ptr(), out.data_ptr(),
            S, steps, stream)
    if rc != 0:
        raise RuntimeError(f"mic_rans_decode_packed launch failed: CUDA error {rc}")
    rans_decode_packed.launches += 1
    return out


rans_decode_packed.launches = 0


# ---------------------------------------------------------------------------
# FF 57 two-table kernel (tableLog up to 16, any alphabet)
# ---------------------------------------------------------------------------

MAX_TABLE = 1 << 16  # the format's tableLog cap, 16


def _two_table_operands(init, tsym, tfb, words, mask, shift, steps):
    out = _table_operands(init, (("tsym", tsym, MAX_TABLE), ("tfb", tfb, MAX_TABLE)),
                          words, mask, shift, steps)
    if out[1] != out[2]:
        raise ValueError(f"tsym width {out[1]} != tfb width {out[2]}")
    return out[0], out[1], out[3]


def _two_table_symbols(init, tsym, tfb, words, mask, shift, steps):
    """The two-table decode's symbols, one [S, 128] int64 tensor per step
    (the plain version of ``TwoTableFront`` in ``csrc/rans_common.cuh``)."""
    S, ts, rows = init.shape[0], tsym.shape[-1], words.shape[1]
    x = _u(init)
    tsym, tfb, m, sft = _u(tsym), _u(tfb), _u(mask), _u(shift)
    words = _u(words).reshape(S, -1)
    cur = torch.zeros((S, 1), dtype=torch.int64, device=init.device)
    for _t in range(steps):
        slot = x & m
        inb = slot < ts
        sc = slot.clamp(max=ts - 1)
        sym = torch.where(inb, torch.gather(tsym, 1, sc), 0)
        fb = torch.where(inb, torch.gather(tfb, 1, sc), 0)
        xn = ((fb >> 16) * _shr(x, sft) + (fb & 0xFFFF)) & _U32
        x, cur = _renorm(xn, cur, words, rows)
        yield sym


def rans_decode_plain(init, tsym, tfb, words, mask, shift, *, steps: int) -> torch.Tensor:
    """Plain-PyTorch twin of the two-table kernel (any device).  Same
    operands and output as :func:`rans_decode`."""
    S = _two_table_operands(init, tsym, tfb, words, mask, shift, steps)[0]
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    for t, sym in enumerate(_two_table_symbols(init, tsym, tfb, words, mask, shift, steps)):
        out[:, t] = _as_i16(sym)
    return out


def rans_decode(init, tsym, tfb, words, mask, shift, *, steps: int) -> torch.Tensor:
    """FF 57 two-table rANS decode of S strips, symbols out: the form for
    tableLog > 12 or alphabets over 4096 that the packed tables cannot
    hold.

    Operands are int32 bit-views (:func:`to_device`) of
    :func:`build_pallas_tables`' first six arrays (tables up to 2^16
    wide).  Returns int16 [S, steps, 128] (bit-view of the u16 symbols).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/rans_decode.cu``, which stages the tables in shared memory when
    they fit a block (tableLog <= 14 on an H100) and reads them from
    device memory otherwise.
    """
    S, ts, rows = _two_table_operands(init, tsym, tfb, words, mask, shift, steps)
    if init.device.type == "cpu":
        return rans_decode_plain(init, tsym, tfb, words, mask, shift, steps=steps)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    from .._build import kernel_library

    lib = kernel_library()
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rans_decode_two_table(
            init.data_ptr(), tsym.data_ptr(), tfb.data_ptr(), ts, words.data_ptr(), rows,
            mask.data_ptr(), shift.data_ptr(), out.data_ptr(), S, steps, stream)
    if rc != 0:
        raise RuntimeError(f"mic_rans_decode_two_table launch failed: CUDA error {rc}")
    rans_decode.launches += 1
    return out


rans_decode.launches = 0


# ---------------------------------------------------------------------------
# FF 41 alias-bucket kernel
# ---------------------------------------------------------------------------


def _alias_operands(init, w0, w1, w2, words, mask, shift, escv, esides, ws,
                    steps, vdd_ws):
    _check_steps(steps, vdd_ws)
    S = init.shape[0]
    dev = init.device
    if S == 0 or init.dim() != 2 or words.dim() != 3 or esides.dim() != 3:
        raise ValueError("init must be [S>0, 128], words and esides [S, rows, 128]")
    rows, erows = words.shape[1], esides.shape[1]
    if rows < 2 or erows < 2:
        raise ValueError(f"words ({rows}) and esides ({erows}) need >= 2 rows")
    for name, t, shape in (("init", init, (S, 128)), ("w0", w0, (S, 128)),
                           ("w1", w1, (S, 128)), ("w2", w2, (S, 128)),
                           ("words", words, (S, rows, 128)),
                           ("mask", mask, (S, 128)), ("shift", shift, (S, 128)),
                           ("escv", escv, (S, 128)),
                           ("esides", esides, (S, erows, 128)),
                           ("ws", ws, (S, 128))):
        _check(name, t, shape, dev)
    return S, rows, erows


def _alias_symbols(init, w0, w1, w2, words, mask, shift, escv, esides, steps, esc):
    """The alias decode's symbols, one [S, 128] int64 tensor per step (the
    plain version of ``AliasFront`` in ``csrc/rans_common.cuh``)."""
    S, rows, erows = init.shape[0], words.shape[1], esides.shape[1]
    x = _u(init)
    w0, w1, w2, m, sft, ev_cmp = _u(w0), _u(w1), _u(w2), _u(mask), _u(shift), _u(escv)
    words = _u(words).reshape(S, -1)
    esides = _u(esides).reshape(S, -1)
    emax = erows * 128 - 256
    cur = torch.zeros((S, 1), dtype=torch.int64, device=init.device)
    ecur = torch.zeros_like(cur)
    for _t in range(steps):
        slot = x & m
        bi = _shr(slot, (sft - 7) & _U32).clamp(max=127)
        o = slot & (m >> 7)
        g0 = torch.gather(w0, 1, bi)
        g1 = torch.gather(w1, 1, bi)
        g2 = torch.gather(w2, 1, bi)
        tp = g1 >> 24
        is_p = o < tp
        fm1 = torch.where(is_p, g1 >> 12, g2 >> 12) & 0xFFF
        sb = torch.where(is_p, g1, g2) & 0xFFF
        j = (sb + o - torch.where(is_p, 0, tp)) & _U32
        sym = torch.where(is_p, g0 >> 16, g0 & 0xFFFF)
        xn = ((fm1 + 1) * _shr(x, sft) + j) & _U32
        if esc:
            is_esc = sym == ev_cmp
            ne = is_esc.to(torch.int64)
            ke = torch.cumsum(ne, dim=1) - ne
            ecl = torch.clamp(ecur, max=emax)
            sym = torch.where(is_esc, torch.gather(esides, 1, ecl + ke), sym)
            ecur = ecur + ne.sum(dim=1, keepdim=True)
        x, cur = _renorm(xn, cur, words, rows)
        yield sym


def rans_decode_alias_plain(init, w0, w1, w2, words, mask, shift, escv,
                            esides, ws, *, steps: int, vdd_ws: int = 0,
                            fused: bool = True, esc: bool = True) -> torch.Tensor:
    """Plain-PyTorch twin of the alias kernel (any device).  Same
    operands and output as :func:`rans_decode_alias`."""
    S = _alias_operands(init, w0, w1, w2, words, mask, shift, escv, esides, ws,
                        steps, vdd_ws)[0]
    inverse = _Inverse(S, vdd_ws, ws, init.device)
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    for t, sym in enumerate(_alias_symbols(init, w0, w1, w2, words, mask, shift,
                                           escv, esides, steps, esc)):
        out[:, t] = _as_i16(inverse(t, sym) if fused else sym)
    return out


def rans_decode_alias(init, w0, w1, w2, words, mask, shift, escv, esides, ws,
                      *, steps: int, vdd_ws: int = 0, fused: bool = True,
                      esc: bool = True) -> torch.Tensor:
    """Fused MICW decode of FF 41 alias strips: three 128-entry bucket
    lookups, escape substitution from the side stream (``esc``), then the
    zzd/vdd inverse of :func:`rans_decode_zzd`; ``fused=False`` returns
    the symbols.

    Operands are int32 bit-views (:func:`to_device`) of
    :func:`build_alias_bucket_tables`' arrays plus ``ws`` [S, 128].
    Returns int16 [S, steps, 128] (bit-view of u16).  CPU tensors take
    the plain version; CUDA tensors launch the kernel of
    ``csrc/rans_decode.cu``.
    """
    S, rows, erows = _alias_operands(init, w0, w1, w2, words, mask, shift,
                                     escv, esides, ws, steps, vdd_ws)
    if init.device.type == "cpu":
        return rans_decode_alias_plain(init, w0, w1, w2, words, mask, shift,
                                       escv, esides, ws, steps=steps,
                                       vdd_ws=vdd_ws, fused=fused, esc=esc)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    from .._build import kernel_library

    lib = kernel_library()
    out = torch.empty((S, steps, 128), dtype=torch.int16, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rans_decode_alias(
            init.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            words.data_ptr(), rows, mask.data_ptr(), shift.data_ptr(),
            escv.data_ptr(), esides.data_ptr(), erows, ws.data_ptr(),
            out.data_ptr(), S, steps, vdd_ws if fused else 0, int(fused),
            int(esc), stream)
    if rc != 0:
        raise RuntimeError(f"mic_rans_decode_alias launch failed: CUDA error {rc}")
    rans_decode_alias.launches += 1
    return out


rans_decode_alias.launches = 0


# ---------------------------------------------------------------------------
# Fused r-mode kernels: either front end + SoA-RLE expand + inverse
# ---------------------------------------------------------------------------

MID_DIRECT = 16383  # RLE midCount of the r-modes (a format constant)
_HUGE = 1 << 30  # run-table entry past nrun (start 2^29 > any position)
_CAP = 1 << 29  # saturation of the run-length and literal-length carries
RLE_ST_SMEM_MAX = 4096  # run-table entries a strip keeps in shared memory (8 bytes each)
RLE_FORMS = {"auto": 0, "serial": 1, "parallel": 2}  # the kernel's expand: form argument


def _rle_operands(S, dev, ws, nrun, nsame, steps, out_rows, maxr):
    if out_rows <= 0 or out_rows % 8:
        raise ValueError(f"out_rows must be a positive multiple of 8, got {out_rows}")
    if maxr <= 0 or maxr % 128 or maxr // 128 > steps:
        raise ValueError(f"maxr must be a positive multiple of 128 and at most "
                         f"steps * 128 = {steps * 128}, got {maxr}")
    for name, t in (("ws", ws), ("nrun", nrun), ("nsame", nsame)):
        _check(name, t, (S, 128), dev)


def _find_run(st1, rb, pos, maxr: int, w: int):
    """Last run r in [rb, min(rb + w, maxr) - 1] whose start <= pos (rb if
    none): the kernel's branch-free binary search, lane by lane."""
    r = rb.expand(pos.shape).clone()
    step = w // 2
    while step:
        c = r + step
        start = torch.gather(st1, 1, c.clamp(max=maxr - 1)) >> 1
        r = torch.where((c < maxr) & (start <= pos), c, r)
        step //= 2
    return r


def _rle_tables_plain(syms, nrun, nsame, *, steps, maxr):
    """Phase 1.5 of the r-kernels on the decoded symbols ``syms`` (int64
    [S, steps * 128], stream order): the run tables st1 and st2 (int64 [S,
    maxr]) and the clamped nrun and nsame (int64 [S, 1])."""
    S, dev = syms.shape[0], syms.device
    lane = torch.arange(128, device=dev)[None, :]
    nrun = nrun[:, :1].to(torch.int64).clamp(0, maxr)
    nsame = nsame[:, :1].to(torch.int64).clamp(0, steps * 128)
    st1 = torch.empty((S, maxr), dtype=torch.int64, device=dev)
    st2 = torch.empty_like(st1)
    len_c = torch.zeros((S, 1), dtype=torch.int64, device=dev)
    same_c, lit_c = len_c.clone(), len_c.clone()

    def exc(v):
        return torch.cumsum(v, dim=1) - v

    for rr in range(maxr // 128):
        c = syms[:, rr * 128:(rr + 1) * 128]
        valid = lane + rr * 128 < nrun
        is_s = valid & (c <= MID_DIRECT)
        si = is_s.to(torch.int64)
        ln = torch.where(valid, torch.where(is_s, c, c - MID_DIRECT), 0)
        litl = torch.where(is_s, 0, ln)
        start, rank, lstart = len_c + exc(ln), same_c + exc(si), lit_c + exc(litl)
        wrow = ((nrun + same_c) >> 7).clamp(0, steps - 2)
        loc = (nrun + rank - (wrow << 7)).clamp(0, 255)
        val = torch.gather(syms, 1, (wrow << 7) + loc)
        st1[:, rr * 128:(rr + 1) * 128] = torch.where(valid, (start << 1) | si, _HUGE)
        st2[:, rr * 128:(rr + 1) * 128] = torch.where(is_s, val,
                                                      nrun + nsame + lstart - start)
        len_c = (len_c + ln.sum(1, keepdim=True)).clamp(max=_CAP)
        same_c = same_c + si.sum(1, keepdim=True)
        lit_c = (lit_c + litl.sum(1, keepdim=True)).clamp(max=_CAP)
    return st1, st2, nrun, nsame


def _rle_expand_plain(syms, ws, nrun, nsame, *, steps, out_rows, maxr, vdd_ws,
                      dense) -> torch.Tensor:
    """Phases 1.5 and 2 of the r-kernels on the decoded symbols ``syms``
    (int64 [S, steps * 128], stream order): the run tables, then one
    128-px row per step through the inverse of :class:`_Inverse`."""
    S, dev = syms.shape[0], syms.device
    lane = torch.arange(128, device=dev)[None, :]
    st1, st2, nrun, nsame = _rle_tables_plain(syms, nrun, nsame, steps=steps, maxr=maxr)
    w = 32 if dense else 256
    inverse = _Inverse(S, vdd_ws, ws, dev)
    out = torch.empty((S, out_rows, 128), dtype=torch.int16, device=dev)
    rb = torch.zeros((S, 1), dtype=torch.int64, device=dev)
    lc = nrun + nsame
    for t in range(out_rows):
        pos = lane + t * 128
        r = _find_run(st1, rb, pos.expand(S, 128), maxr, w)
        rn = _find_run(st1, rb, torch.full((S, 1), (t + 1) * 128, device=dev), maxr, w)
        g1, g2 = torch.gather(st1, 1, r), torch.gather(st2, 1, r)
        is_s = (g1 & 1) == 1
        lrow = (lc >> 7).clamp(max=steps - 2)
        li = (g2 + pos - (lrow << 7)).clamp(0, 255)
        tok = torch.where(is_s, g2, torch.gather(syms, 1, (lrow << 7) + li))
        lc = (lc + (~is_s).sum(1, keepdim=True)).clamp(max=steps * 128 - 1)
        rb = rn
        out[:, t] = _as_i16(inverse(t, tok))
    return out


def rle_honest(syms, nrun, nsame, *, steps: int, maxr: int, dense: bool) -> torch.Tensor:
    """The r-kernel's per-strip honesty test on the host (bool [S]): the
    counts ``nrun`` / ``nsame`` lie in [0, maxr] / [0, steps * 128] as
    given, the run starts of phase 1.5 strictly increase over the first
    nrun runs, and with ``dense`` no 32 runs start inside one interval
    (128 t, 128 t + 128].  A strip that passes takes the kernel's parallel
    expand, which then finds the runs the windowed serial search finds;
    one that fails takes the serial expand.  ``syms`` as for
    :func:`_rle_expand_plain` (int64 [S, steps * 128])."""
    st1, _st2, nr, ns = _rle_tables_plain(syms, nrun, nsame, steps=steps, maxr=maxr)
    ok = ((nrun[:, :1].to(torch.int64) == nr) & (nsame[:, :1].to(torch.int64) == ns))[:, 0]
    start = st1 >> 1
    c = torch.arange(maxr, device=syms.device)[None, :]
    ok &= ~((start[:, 1:] <= start[:, :-1]) & (c[:, 1:] < nr)).any(dim=1)
    if dense:
        q = (start - 1) >> 7
        ok &= ~((q[:, 31:] == q[:, :-31]) & (c[:, 31:] < nr)).any(dim=1)
    return ok


def rans_decode_rle_plain(init, tpk, alpha, words, mask, shift, ws, nrun, nsame, *,
                          steps: int, out_rows: int, maxr: int, vdd_ws: int = 0,
                          dense: bool = False) -> torch.Tensor:
    """Plain-PyTorch twin of the FF 57 r-kernel (any device).  Same
    operands and output as :func:`rans_decode_rle`."""
    S = _zzd_operands(init, tpk, alpha, words, mask, shift, ws, steps, vdd_ws)[0]
    _rle_operands(S, init.device, ws, nrun, nsame, steps, out_rows, maxr)
    syms = torch.cat(list(_packed_symbols(init, tpk, alpha, words, mask, shift, steps)),
                     dim=1)
    return _rle_expand_plain(syms, ws, nrun, nsame, steps=steps, out_rows=out_rows,
                             maxr=maxr, vdd_ws=vdd_ws, dense=dense)


def rans_decode_rle(init, tpk, alpha, words, mask, shift, ws, nrun, nsame, *,
                    steps: int, out_rows: int, maxr: int, vdd_ws: int = 0,
                    dense: bool = False) -> torch.Tensor:
    """Fused MICW decode of FF 57 r-mode strips (zzr / vdr / pdr):
    packed-table rANS, the SoA-RLE expand, then the inverse of
    :func:`rans_decode_zzd` (pdr's column prefix sum is the caller's).

    Operands are those of :func:`rans_decode_zzd` plus ``nrun`` and
    ``nsame`` [S, 128] (each strip's run and same-run counts, broadcast
    over the lanes).  ``maxr`` is the run-table capacity (a multiple of
    128, at most ``steps * 128``); ``dense`` selects the 32-run search
    window of FLAG_RDENSE streams over the 256-run one.  Returns int16
    [S, out_rows, 128] (bit-view of u16 pixels).  CPU tensors take the
    plain version; CUDA tensors launch the kernel of ``csrc/rans_rle.cu``
    for this one bucket (:func:`rans_decode_rle_groups` launches it for
    many), reusing the descriptors of the last call while the operands are
    the same tensors (see :func:`_bucket_packing`).
    """
    ops = (init, tpk, alpha, words, mask, shift, ws, nrun, nsame)
    kw = dict(steps=steps, out_rows=out_rows, maxr=maxr, vdd_ws=vdd_ws, dense=dense)
    if init.device.type == "cpu":
        return rans_decode_rle_plain(*ops, **kw)
    (out,) = _rle_launch(_bucket_packing(rans_decode_rle, ops, kw))
    rans_decode_rle.launches += 1
    return out


rans_decode_rle.launches = 0


def rans_decode_rle_alias_plain(init, w0, w1, w2, words, mask, shift, escv, esides,
                                ws, nrun, nsame, *, steps: int, out_rows: int,
                                maxr: int, esc: bool, vdd_ws: int = 0,
                                dense: bool = False) -> torch.Tensor:
    """Plain-PyTorch twin of the FF 41 r-kernel (any device).  Same
    operands and output as :func:`rans_decode_rle_alias`."""
    S = _alias_operands(init, w0, w1, w2, words, mask, shift, escv, esides, ws,
                        steps, vdd_ws)[0]
    _rle_operands(S, init.device, ws, nrun, nsame, steps, out_rows, maxr)
    syms = torch.cat(list(_alias_symbols(init, w0, w1, w2, words, mask, shift, escv,
                                         esides, steps, esc)), dim=1) & 0xFFFF
    return _rle_expand_plain(syms, ws, nrun, nsame, steps=steps, out_rows=out_rows,
                             maxr=maxr, vdd_ws=vdd_ws, dense=dense)


def rans_decode_rle_alias(init, w0, w1, w2, words, mask, shift, escv, esides, ws,
                          nrun, nsame, *, steps: int, out_rows: int, maxr: int,
                          esc: bool, vdd_ws: int = 0, dense: bool = False) -> torch.Tensor:
    """Fused MICW decode of FF 41 r-mode strips: the alias front end of
    :func:`rans_decode_alias` (escape substitution with ``esc``) behind
    the expand and inverse of :func:`rans_decode_rle`, whose ``nrun``,
    ``nsame``, ``out_rows``, ``maxr`` and ``dense`` it takes.  Returns
    int16 [S, out_rows, 128].  CPU tensors take the plain version; CUDA
    tensors launch the kernel of ``csrc/rans_rle.cu`` for this one bucket,
    as :func:`rans_decode_rle` does.
    """
    ops = (init, w0, w1, w2, words, mask, shift, escv, esides, ws, nrun, nsame)
    kw = dict(steps=steps, out_rows=out_rows, maxr=maxr, esc=esc, vdd_ws=vdd_ws, dense=dense)
    if init.device.type == "cpu":
        return rans_decode_rle_alias_plain(*ops, **kw)
    (out,) = _rle_launch(_bucket_packing(rans_decode_rle_alias, ops, kw))
    rans_decode_rle_alias.launches += 1
    return out


rans_decode_rle_alias.launches = 0

_RLE_PLAIN = {rans_decode_rle: rans_decode_rle_plain,
              rans_decode_rle_alias: rans_decode_rle_alias_plain}

# One r-mode bucket's descriptor (csrc/rans_rle.cu:RleGroup): the operand
# pointers (init, tpk | w0, alpha | w1, w2, words, mask, shift, escv,
# esides, ws, nrun, nsame; 0 where the front end has none), the element
# offsets of its output, symbol scratch and run-table scratch (-1: shared
# memory) in the launch's flat buffers, and (alias, ts, asz, rows, erows,
# steps, out_rows, maxr, vdd_ws, dense, esc, 0).
_RLE_GROUP_DESC = np.dtype([("ptr", "<u8", (12,)), ("off", "<i8", (3,)), ("arg", "<i4", (12,))])


def _rle_group(fn, ops, kw):
    """Checks one group ``(fn, operands, kwargs)`` as ``fn`` checks its
    operands; returns (S, the 12 descriptor tensors, the 12 arguments)."""
    steps, out_rows, maxr = kw["steps"], kw["out_rows"], kw["maxr"]
    vdd_ws, dense = kw.get("vdd_ws", 0), bool(kw.get("dense", False))
    if fn is rans_decode_rle:
        init, tpk, alpha, words, mask, shift, ws, nrun, nsame = ops
        S, ts, asz, rows = _zzd_operands(init, tpk, alpha, words, mask, shift, ws, steps,
                                         vdd_ws)
        tensors = (init, tpk, alpha, None, words, mask, shift, None, None, ws, nrun, nsame)
        args = (0, ts, asz, rows, 0)
        esc = 0
    elif fn is rans_decode_rle_alias:
        init, w0, w1, w2, words, mask, shift, escv, esides, ws, nrun, nsame = ops
        S, rows, erows = _alias_operands(init, w0, w1, w2, words, mask, shift, escv, esides,
                                         ws, steps, vdd_ws)
        tensors = tuple(ops)
        args = (1, 0, 0, rows, erows)
        esc = int(bool(kw["esc"]))
    else:
        raise ValueError(f"not an r-kernel wrapper: {fn}")
    _rle_operands(S, init.device, ws, nrun, nsame, steps, out_rows, maxr)
    return S, tensors, (*args, steps, out_rows, maxr, vdd_ws, int(dense), esc, 0)


class RlePacking:
    """The strips of some r-mode buckets as the blocks of one launch, with
    the kernel's descriptors on the device.

    ``groups`` is a list of ``(fn, operands, kwargs)``: ``fn`` is
    :func:`rans_decode_rle` or :func:`rans_decode_rle_alias`, whose
    operands and keyword arguments the group holds (the front ends mix in
    one launch).  Every group is checked as its wrapper checks it; outputs
    and scratch are laid out group after group in flat buffers
    (``out_offs``, ``out_shapes``; run tables of more than
    ``RLE_ST_SMEM_MAX`` entries get device scratch, the others shared
    memory); ``blocks`` (int32 [n, 2]: group, strip) runs longest chain
    first: most entropy steps, then most output rows, then group and strip
    order.  The packing holds the groups' tensors: it is valid for them
    only.
    """

    def __init__(self, groups):
        if not groups:
            raise ValueError("expected at least one group")
        dev = groups[0][1][0].device
        desc = np.zeros(len(groups), _RLE_GROUP_DESC)
        self.groups, self.out_shapes, self.out_offs = [], [], []
        out_at = syms_at = st_at = tab = st_words = 0
        chain = []  # (steps, out_rows, S) of each group
        for g, (fn, ops, kw) in enumerate(groups):
            S, tensors, args = _rle_group(fn, ops, kw)
            if tensors[0].device != dev:
                raise ValueError(f"group {g} on {tensors[0].device}, group 0 on {dev}")
            steps, out_rows, maxr = args[5:8]
            st_off = -1
            if maxr > RLE_ST_SMEM_MAX:
                st_off, st_at = st_at, st_at + S * 2 * maxr
            else:
                st_words = max(st_words, 2 * maxr)
            desc[g] = ([0 if t is None else t.data_ptr() for t in tensors],
                       [out_at, syms_at, st_off], args)
            self.groups.append((fn, tuple(ops), dict(kw)))
            self.out_shapes.append((S, out_rows, 128))
            self.out_offs.append(out_at)
            out_at += S * out_rows * 128
            syms_at += S * steps * 128
            tab = max(tab, 3 * 128 if args[0] else args[1] + args[2])
            chain.append((steps, out_rows, S))
        steps, rows, n = np.array(chain, np.int64).T
        grp = np.repeat(np.arange(len(chain)), n)
        strip = np.arange(grp.size) - np.repeat(np.cumsum(n) - n, n)
        order = np.lexsort((strip, grp, -rows[grp], -steps[grp]))
        self.blocks = np.stack([grp[order], strip[order]], axis=1).astype(np.int32)
        self.desc = desc
        self.tab_words, self.st_words = tab, st_words
        self.out_total, self.syms_total, self.st_total = out_at, syms_at, st_at
        self.families = sorted({fn.__name__ for fn, _o, _k in self.groups})
        self.device = dev
        if dev.type == "cuda":
            # One copy from pinned memory, queued on the stream: no host sync.
            raw = np.concatenate([desc.view(np.uint8).reshape(-1),
                                  self.blocks.view(np.uint8).reshape(-1)])
            host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
            host.numpy()[:] = raw
            buf = host.to(dev, non_blocking=True)
            self.gdesc, self.bdesc = buf[:desc.nbytes], buf[desc.nbytes:]

    def holds(self, groups) -> bool:
        """Whether ``groups`` are the tensors this packing was built for."""
        return len(groups) == len(self.groups) and all(
            fn is mine[0] and len(ops) == len(mine[1])
            and all(a is b for a, b in zip(ops, mine[1])) and dict(kw) == mine[2]
            for (fn, ops, kw), mine in zip(groups, self.groups))


_BUCKET_PACKING = {}  # one-bucket wrapper -> the packing of its last call


def _bucket_packing(fn, ops, kw) -> RlePacking:
    """The one-bucket packing of ``fn``'s call: the last call's while it
    holds the same tensors and arguments (a plan calls a bucket with the
    same tensors every run), else a new one: building a packing on the
    host and copying it to the card takes about as long as a bucket's
    kernel (PERF.md rows 4 and 5).  The kept packing holds its tensors:
    they live until the wrapper is called on others."""
    last = _BUCKET_PACKING.get(fn)
    if last is None or not last.holds([(fn, ops, kw)]):
        last = _BUCKET_PACKING[fn] = RlePacking([(fn, ops, kw)])
    return last


def _rle_launch(packing: RlePacking, form: str = "auto", lib=None) -> list[torch.Tensor]:
    """The r-kernel over a packing's groups, one launch; one output per
    group, views into one flat buffer.  ``form`` forces the kernel's expand
    (``"serial"`` or ``"parallel"``; the parallel form equals the plain twin
    only on strips that pass the honesty test) where ``"auto"`` lets the
    per-strip test pick it; the tests and ``scripts/rle_design_points.py``
    force each.  ``lib`` is another build of the kernel library."""
    if form not in RLE_FORMS:
        raise ValueError(f"form must be one of {sorted(RLE_FORMS)}, got {form!r}")
    dev = packing.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(packing.out_total, dtype=torch.int16, device=dev)
    syms = torch.empty(packing.syms_total, dtype=torch.int16, device=dev)
    st = torch.empty(max(packing.st_total, 1), dtype=torch.int32, device=dev)
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_rle_decode_groups(
            packing.gdesc.data_ptr(), packing.bdesc.data_ptr(), len(packing.blocks),
            out.data_ptr(), syms.data_ptr(), st.data_ptr(), packing.tab_words,
            packing.st_words, RLE_FORMS[form], stream)
    if rc != 0:
        raise RuntimeError(f"mic_rle_decode_groups launch failed: CUDA error {rc}")
    return [out[o:o + S * R * 128].view(S, R, 128)
            for o, (S, R, _l) in zip(packing.out_offs, packing.out_shapes)]


def rans_decode_rle_groups_plain(groups) -> list[torch.Tensor]:
    """Plain-PyTorch twin of :func:`rans_decode_rle_groups`: each group's
    plain r-kernel twin in turn."""
    return [_RLE_PLAIN[fn](*ops, **kw) for fn, ops, kw in groups]


def rans_decode_rle_groups(groups, packing: RlePacking | None = None) -> list[torch.Tensor]:
    """Decode the strips of several r-mode buckets in one launch.

    ``groups`` is a list of ``(fn, operands, kwargs)`` as
    :class:`RlePacking` takes them, all on one device; returns one output
    per group, each as ``fn`` returns it.  ``packing`` is a packing built
    earlier for these very tensors (a plan builds it once); without it one
    is built here.  CPU tensors take the plain twin group by group; CUDA
    tensors launch the kernel of ``csrc/rans_rle.cu`` once, whose per-strip
    honesty test picks each strip's expand.  ``.launches`` counts the
    launches, ``.family_launches`` per wrapper name the launches that held
    that front end's strips.
    """
    if not groups:
        return []
    devs = {ops[0].device for _fn, ops, _kw in groups}
    if len(devs) > 1:
        raise ValueError(f"groups on several devices: {sorted(map(str, devs))}")
    if groups[0][1][0].device.type == "cpu":
        return rans_decode_rle_groups_plain(groups)
    if packing is None:
        packing = RlePacking(groups)
    elif not packing.holds(groups):
        raise ValueError("packing was built for other groups")
    outs = _rle_launch(packing)
    rans_decode_rle_groups.launches += 1
    for name in packing.families:
        rans_decode_rle_groups.family_launches[name] += 1
    return outs


rans_decode_rle_groups.launches = 0
rans_decode_rle_groups.family_launches = {"rans_decode_rle": 0, "rans_decode_rle_alias": 0}
