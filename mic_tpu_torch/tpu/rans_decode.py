"""rANS decode kernels of MICW: the fused direct modes (zzd / vdd / pdd),
the fused r-modes (zzr / vdr / pdr) and the symbols-out forms the post
path (``post.py``) decodes the other strips with.

Counterpart of the decode half of ``mic_tpu.tpu.pallas_rans``:

* ``build_packed_tables`` / ``build_pallas_tables`` /
  ``build_alias_bucket_tables`` — the numpy operand builders, carried
  over unchanged so their arrays are identical (pinned by
  ``tests/test_torch_host_format.py`` and ``tests/test_torch_post_decode.py``);
* ``to_device`` — numpy ``uint32`` operands to int32 bit-view tensors;
* ``rans_decode_zzd`` / ``rans_decode_alias`` — one bucket of the
  direct-mode kernel in ``csrc/rans_direct.cu`` (either entropy front
  end, then the zzd / vdd inverse; ``fused=False`` gives the alias
  symbols);
* ``rans_decode_packed`` / ``rans_decode`` — one bucket of the same
  kernel, FF 57 symbols out for the post path: the packed-table front end
  with no inverse (tableLog <= 12, alphabets <= 4096) and the two-table
  front end (tableLog up to 16, any alphabet);
* ``rans_decode_direct_groups`` — many buckets of those four wrappers,
  the front ends mixed, pdd's column sum fused, in one launch (two where
  some strips' tables fit no block of the first; :class:`DirectPacking`
  lays them out);
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
    "rans_decode_direct_groups",
    "rans_decode_direct_groups_plain",
    "DirectPacking",
    "two_table_symbols",
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
    step (the plain version of the packed front end of
    ``csrc/rans_direct.cu``)."""
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
    (bit-view of u16 pixels; for pdd the row prefix, pdd's first pass).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/rans_direct.cu`` for this one bucket
    (:func:`rans_decode_direct_groups` launches it for many), reusing the
    descriptors of the last call while the operands are the same tensors
    (see :func:`_bucket_packing`).
    """
    ops = (init, tpk, alpha, words, mask, shift, ws)
    kw = dict(steps=steps, vdd_ws=vdd_ws)
    if init.device.type == "cpu":
        return rans_decode_zzd_plain(*ops, **kw)
    return _direct_bucket(rans_decode_zzd, ops, kw)


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
    ``csrc/rans_direct.cu`` for this one bucket (its packed front end with
    no inverse), as :func:`rans_decode_zzd` does.
    """
    ops = (init, tpk, alpha, words, mask, shift)
    if init.device.type == "cpu":
        return rans_decode_packed_plain(*ops, steps=steps)
    return _direct_bucket(rans_decode_packed, ops, dict(steps=steps))


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
    (the plain version of the two-table front end of
    ``csrc/rans_direct.cu``)."""
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
    ``csrc/rans_direct.cu`` for this one bucket (its two-table front end),
    which stages the tables in shared memory, 6 bytes a slot
    (:func:`two_table_symbols`), where they fit a block (tableLog <= 15 on
    an H100) and reads them from device memory otherwise.
    """
    ops = (init, tsym, tfb, words, mask, shift)
    if init.device.type == "cpu":
        return rans_decode_plain(*ops, steps=steps)
    return _direct_bucket(rans_decode, ops, dict(steps=steps))


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
    ``csrc/rans_direct.cu`` for this one bucket, as :func:`rans_decode_zzd`
    does.
    """
    ops = (init, w0, w1, w2, words, mask, shift, escv, esides, ws)
    kw = dict(steps=steps, vdd_ws=vdd_ws, fused=fused, esc=esc)
    if init.device.type == "cpu":
        return rans_decode_alias_plain(*ops, **kw)
    return _direct_bucket(rans_decode_alias, ops, kw)


rans_decode_alias.launches = 0


# ---------------------------------------------------------------------------
# Every direct and post bucket of a plan in one launch: three front ends,
# pdd fused
# ---------------------------------------------------------------------------

_DIRECT_PLAIN = {rans_decode_zzd: rans_decode_zzd_plain,
                 rans_decode_alias: rans_decode_alias_plain,
                 rans_decode_packed: rans_decode_packed_plain,
                 rans_decode: rans_decode_plain}
_DIRECT_KW = {rans_decode_zzd: {"steps", "vdd_ws", "pdd_ws"},
              rans_decode_alias: {"steps", "vdd_ws", "fused", "esc", "pdd_ws"},
              rans_decode_packed: {"steps"},
              rans_decode: {"steps"}}
DIRECT_STRIPS_PER_BLOCK = 4  # csrc/rans_direct.cu:kStrips, teams a block
_RING_WORDS = 8 * 128  # a strip's word ring
_ESC_RING_WORDS = 16 * 128  # an FF 41 strip's escape ring, when it has escapes
_MAX_BLOCK_WORDS = (232448 - 512) // 4  # the H100's opt-in shared memory less the static

# One bucket's descriptor (csrc/rans_direct.cu:DirectGroup): the operand
# pointers (init, tpk | w0 | tfb, alpha | w1 | the u16 symbols, w2, words,
# mask, shift, escv, esides, ws; 0 where the front end has none), the
# element offset of its output in the launch's flat buffer, and (front, ts,
# asz, rows, erows, steps, inv, cw, esc, tdev); front 0 packed, 1 alias, 2
# two tables; inv 0 symbols, 1 zzd, 2 vdd, 3 pdd; tdev 1: the two tables
# read from device memory.
_DIRECT_GROUP_DESC = np.dtype([("ptr", "<u8", (10,)), ("off", "<i8"), ("arg", "<i4", (10,))])


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def two_table_symbols(tsym: torch.Tensor) -> torch.Tensor:
    """tsym (int32 [S, ts]) as the kernel's two-table front end reads it:
    narrowed to u16, which is exact (a symbol is < 2^16; the kernel keeps a
    symbol's low 16 bits, as the plain twin does), as int16 [S, ts rounded
    up to 8] bit-views whose padding is never read.  Beside tfb, which the
    kernel reads as :func:`build_pallas_tables` builds it: 6 bytes a slot."""
    S, ts = tsym.shape
    sym = torch.zeros((S, _round8(ts)), dtype=torch.int16, device=tsym.device)
    sym[:, :ts] = _as_i16(tsym)
    return sym


def _direct_group(fn, ops, kw):
    """Checks one group ``(fn, operands, kwargs)`` as ``fn`` checks its
    operands, plus ``pdd_ws``; returns (S, the 10 descriptor tensors, the
    10 arguments, the strip's shared-memory words).  A two-table group's
    tensors hold tsym where the descriptor takes its u16 copy
    (:func:`two_table_symbols`, which the packing makes), and its words
    are those of its tables staged."""
    if fn not in _DIRECT_KW:
        raise ValueError(f"not a direct-kernel wrapper: {fn}")
    extra = set(kw) - _DIRECT_KW[fn]
    if extra:
        raise ValueError(f"{fn.__name__}: unexpected arguments {sorted(extra)}")
    steps, vdd_ws, pdd_ws = kw["steps"], kw.get("vdd_ws", 0), kw.get("pdd_ws", 0)
    fused, esc = fn is not rans_decode_packed, 0
    if fn is rans_decode_zzd or fn is rans_decode_packed:
        init, tpk, alpha, words, mask, shift = ops[:6]
        if fn is rans_decode_zzd:
            ws = ops[6]
            S, ts, asz, rows = _zzd_operands(init, tpk, alpha, words, mask, shift, ws, steps,
                                             vdd_ws)
        else:
            ws = None
            S, ts, asz, rows = _packed_operands(*ops, steps)
        tensors = (init, tpk, alpha, None, words, mask, shift, None, None, ws)
        args = (0, ts, asz, rows, 0)
        tab = (ts + 4) // 4 * 4 + (asz + 4) // 4 * 4  # each table and a zero word
    elif fn is rans_decode:
        init, tsym, tfb, words, mask, shift = ops
        S, ts, rows = _two_table_operands(*ops, steps)
        tensors = (init, tfb, tsym, None, words, mask, shift, None, None, None)
        args, fused = (2, ts, _round8(ts), rows, 0), False
        tab = (ts + 3) // 4 * 4 + _round8(ts) // 2  # tfb, then the u16 symbols
    else:
        S, rows, erows = _alias_operands(*ops, steps, vdd_ws)
        tensors = tuple(ops)
        args, fused = (1, 0, 0, rows, erows), bool(kw.get("fused", True))
        esc = int(bool(kw.get("esc", True)))
        tab = 3 * 128 + esc * _ESC_RING_WORDS  # the bucket tables, the escapes' ring
    if not isinstance(pdd_ws, int) or pdd_ws < 0:
        raise ValueError(f"pdd_ws must be an int >= 0, got {pdd_ws!r}")
    if pdd_ws and (vdd_ws or not fused):
        raise ValueError("pdd_ws needs the zzd inverse (vdd_ws 0, fused)")
    inv, cw = ((0, 0) if not fused else (3, pdd_ws) if pdd_ws
               else (2, vdd_ws) if vdd_ws else (1, 0))
    carry = cw * 64 if inv >= 2 else 0  # vdd's and pdd's column carry, u16
    return S, tensors, (*args, steps, inv, cw, esc, 0), _RING_WORDS + tab + carry


def direct_strip_fits(fn, ops, kw) -> bool:
    """Whether one strip of the group ``(fn, operands, kwargs)`` fits a
    block of the direct kernel: its shared-memory words as
    :func:`_direct_group` counts them (ring, tables, column carry) within
    the card's opt-in shared memory.  A plan asks this of a pdd bucket
    with its ``pdd_ws`` and, where the carry leaves no room, runs the
    bucket without it (the row prefix, then the column sum in torch ops),
    on every device alike."""
    return _direct_group(fn, ops, kw)[3] <= _MAX_BLOCK_WORDS


def _pdd_columns_plain(out: torch.Tensor, cw: int) -> torch.Tensor:
    """pdd's second pass on a row-prefix output (int16 [S, steps, 128]):
    the column sum over rows of ``cw`` 128-lane chunks, mod 2^16 (as
    ``_Bucket.finish`` and ``mic_tpu``'s ``_stacked_zzd_fused`` take it)."""
    S, steps, _l = out.shape
    R = -(-steps // cw)
    u = torch.nn.functional.pad(out.to(torch.int64) & 0xFFFF, (0, 0, 0, R * cw - steps))
    u = u.reshape(S, R, cw * 128).cumsum(dim=1).reshape(S, R * cw, 128)[:, :steps]
    return _as_i16(u)


class _Packing:
    """What both group packings share: the groups they hold and the one
    copy of their descriptors to the card."""

    def holds(self, groups) -> bool:
        """Whether ``groups`` are the tensors this packing was built for."""
        return len(groups) == len(self.groups) and all(
            fn is mine[0] and len(ops) == len(mine[1])
            and all(a is b for a, b in zip(ops, mine[1])) and dict(kw) == mine[2]
            for (fn, ops, kw), mine in zip(groups, self.groups))

    def _upload(self, *arrays) -> list[torch.Tensor]:
        """The arrays' bytes on the packing's device, one view each: one
        copy from pinned memory, queued on the stream (no host sync)."""
        raw = np.concatenate([a.view(np.uint8).reshape(-1) for a in arrays])
        host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = raw
        buf = host.to(self.device, non_blocking=True)
        ends = np.cumsum([a.nbytes for a in arrays])
        return [buf[e - a.nbytes:e] for a, e in zip(arrays, ends)]


class DirectPacking(_Packing):
    """The strips of some buckets as the teams of one launch of the direct
    kernel, with the kernel's descriptors on the device.

    ``groups`` is a list of ``(fn, operands, kwargs)``: ``fn`` is
    :func:`rans_decode_zzd`, :func:`rans_decode_alias`,
    :func:`rans_decode_packed` or :func:`rans_decode`, whose operands and
    keyword arguments the group holds, plus for the first two an optional
    ``pdd_ws`` (the chunks of 128 lanes in a pdd row: the kernel then adds
    pdd's column sum to the row prefix; 0, the default, leaves the
    wrapper's output).  The front ends mix in one launch.  Every group is
    checked as its wrapper checks it; outputs are laid out group after
    group in one flat buffer (``out_offs``, ``out_shapes``).  Each strip
    takes shared memory for its ring, its group's tables (a two-table
    strip 6 bytes a slot), for FF 41 with escapes a ring for them, and for
    vdd and pdd its column carry (``strip_words``).  Two tables past a
    block's shared memory (tl 16) are read from device memory, and such a
    strip takes only its ring.  ``blocks`` (int32 [n, 4, 4]: group or -1,
    strip, word offset, 0 per team) holds ``per_block`` consecutive strips
    a block, or fewer where the largest strip leaves no room for them
    (one at tl 15), longest chain first (most steps, then group and strip
    order), so a block's strips are mostly of one group and end together;
    ``smem_bytes`` is a block's largest need.  ``per_block`` below 4 leaves
    teams idle (the design script's "alone" shape).  The packing holds the
    groups' tensors: it is valid for them only.
    """

    def __init__(self, groups, *, per_block: int = DIRECT_STRIPS_PER_BLOCK):
        if not groups:
            raise ValueError("expected at least one group")
        if not 1 <= per_block <= DIRECT_STRIPS_PER_BLOCK:
            raise ValueError(f"per_block must be in [1, {DIRECT_STRIPS_PER_BLOCK}], "
                             f"got {per_block}")
        dev = groups[0][1][0].device
        desc = np.zeros(len(groups), _DIRECT_GROUP_DESC)
        self.groups, self.out_shapes, self.out_offs, self.strip_words = [], [], [], []
        self._narrowed = []  # the two-table groups' u16 symbols, which the descriptors name
        out_at = 0
        for g, (fn, ops, kw) in enumerate(groups):
            S, tensors, args, words = _direct_group(fn, ops, kw)
            if tensors[0].device != dev:
                raise ValueError(f"group {g} on {tensors[0].device}, group 0 on {dev}")
            if dev.type == "cuda" and tensors[4].data_ptr() % 16:
                raise ValueError(f"group {g}: words must be 16-byte aligned")
            if fn is rans_decode:
                tensors = (*tensors[:2], two_table_symbols(ops[1]), *tensors[3:])
                self._narrowed.append(tensors[2])
                if words > _MAX_BLOCK_WORDS:
                    args, words = (*args[:9], 1), _RING_WORDS
            desc[g] = ([0 if t is None else t.data_ptr() for t in tensors], out_at, args)
            self.groups.append((fn, tuple(ops), dict(kw)))
            self.out_shapes.append((S, args[5], 128))
            self.out_offs.append(out_at)
            self.strip_words.append(words)
            out_at += S * args[5] * 128
        self.desc, self.out_total, self.device, self.per_block = desc, out_at, dev, per_block
        self.families = sorted({fn.__name__ for fn, _o, _k in self.groups})
        self._lay_out()

    def _lay_out(self):
        """``blocks`` and ``smem_bytes`` from ``strip_words``; the upload."""
        per = min(self.per_block, _MAX_BLOCK_WORDS // max(self.strip_words))
        if per == 0:
            raise ValueError(f"a strip needs {4 * max(self.strip_words)} bytes of shared "
                             f"memory, a block has {4 * _MAX_BLOCK_WORDS}")
        steps, n = np.array([shape[1::-1] for shape in self.out_shapes], np.int64).T
        grp = np.repeat(np.arange(len(n)), n)
        strip = np.arange(grp.size) - np.repeat(np.cumsum(n) - n, n)
        order = np.lexsort((strip, grp, -steps[grp]))
        grp, strip = grp[order], strip[order]
        n_blocks = -(-grp.size // per)
        team = np.arange(grp.size) // per * DIRECT_STRIPS_PER_BLOCK + np.arange(grp.size) % per
        need = np.asarray(self.strip_words, np.int64)[grp]
        at = np.cumsum(need) - need
        blocks = np.full((n_blocks * DIRECT_STRIPS_PER_BLOCK, 4), -1, np.int32)
        blocks[team, 0], blocks[team, 1] = grp, strip
        blocks[team, 2], blocks[team, 3] = at - at[np.arange(grp.size) // per * per], 0
        self.blocks = blocks.reshape(n_blocks, DIRECT_STRIPS_PER_BLOCK, 4)
        self.smem_bytes = int(4 * np.add.reduceat(need, np.arange(0, grp.size, per)).max())
        if self.device.type == "cuda":
            self.gdesc, self.bdesc = self._upload(self.desc, self.blocks)


def _tables_from_memory(packing: DirectPacking) -> DirectPacking:
    """``packing`` with every two-table group's tables read from device
    memory, as at tl 16 (such a strip then takes only its ring): the
    comparison with staged tables of ``scripts/direct_design_points.py``
    and the CUDA tests.  Edits the packing and returns it."""
    for g, (fn, _o, _k) in enumerate(packing.groups):
        if fn is rans_decode:
            packing.desc["arg"][g, 9] = 1
            packing.strip_words[g] = _RING_WORDS
    packing._lay_out()
    return packing


def _direct_launch(packing: DirectPacking, lib=None) -> list[torch.Tensor]:
    """The direct kernel over a packing's groups, one launch; one output
    per group, views into one flat buffer.  ``lib`` is another build of the
    kernel library (``scripts/direct_design_points.py``)."""
    dev = packing.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(packing.out_total, dtype=torch.int16, device=dev)
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_direct_decode_groups(packing.gdesc.data_ptr(), packing.bdesc.data_ptr(),
                                          len(packing.blocks), out.data_ptr(),
                                          packing.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"mic_direct_decode_groups launch failed: CUDA error {rc}")
    return [out[o:o + S * T * 128].view(S, T, 128)
            for o, (S, T, _l) in zip(packing.out_offs, packing.out_shapes)]


def _direct_bucket(fn, ops, kw) -> torch.Tensor:
    """One bucket of a direct-kernel wrapper on the card, with the
    wrapper's kept packing (:func:`_bucket_packing`); counts its launch."""
    (out,) = _direct_launch(_bucket_packing(fn, ops, kw))
    fn.launches += 1
    return out


def rans_decode_direct_groups_plain(groups) -> list[torch.Tensor]:
    """Plain-PyTorch twin of :func:`rans_decode_direct_groups`: each
    group's plain wrapper twin in turn, then pdd's column sum where the
    group asks for it."""
    outs = []
    for fn, ops, kw in groups:
        _direct_group(fn, ops, kw)
        kw = dict(kw)
        pdd_ws = kw.pop("pdd_ws", 0)
        out = _DIRECT_PLAIN[fn](*ops, **kw)
        outs.append(_pdd_columns_plain(out, pdd_ws) if pdd_ws else out)
    return outs


def rans_decode_direct_groups(groups, packing: DirectPacking | None = None) -> list[torch.Tensor]:
    """Decode the strips of several buckets of the direct kernel's four
    wrappers in one launch.

    ``groups`` is a list of ``(fn, operands, kwargs)`` as
    :class:`DirectPacking` takes them, all on one device; returns one
    output per group, int16 [S, steps, 128], each as ``fn`` returns it or,
    with ``pdd_ws``, with pdd's column sum added.  ``packing`` is a packing
    built earlier for these very tensors (a plan builds it once); without
    it one is built here.  CPU tensors take the plain twin group by group;
    CUDA tensors launch the kernel of ``csrc/rans_direct.cu``.
    ``.launches`` counts the launches, ``.family_launches`` per wrapper
    name the launches that held that front end's strips.
    """
    if not groups:
        return []
    devs = {ops[0].device for _fn, ops, _kw in groups}
    if len(devs) > 1:
        raise ValueError(f"groups on several devices: {sorted(map(str, devs))}")
    if groups[0][1][0].device.type == "cpu":
        return rans_decode_direct_groups_plain(groups)
    if packing is None:
        packing = DirectPacking(groups)
    elif not packing.holds(groups):
        raise ValueError("packing was built for other groups")
    outs = _direct_launch(packing)
    rans_decode_direct_groups.launches += 1
    for name in packing.families:
        rans_decode_direct_groups.family_launches[name] += 1
    return outs


rans_decode_direct_groups.launches = 0
rans_decode_direct_groups.family_launches = dict.fromkeys(
    ("rans_decode_zzd", "rans_decode_alias", "rans_decode_packed", "rans_decode"), 0)


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


class RlePacking(_Packing):
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
            self.gdesc, self.bdesc = self._upload(desc, self.blocks)


_BUCKET_PACKING = {}  # one-bucket wrapper -> the packing of its last call


def _bucket_packing(fn, ops, kw):
    """The one-bucket packing of ``fn``'s call (an :class:`RlePacking` or a
    :class:`DirectPacking`): the last call's while it holds the same
    tensors and arguments (a plan calls a bucket with the same tensors
    every run), else a new one: building a packing on the host and copying
    it to the card takes about as long as a bucket's kernel (PERF.md rows
    4 and 5).  The kept packing holds its tensors: they live until the
    wrapper is called on others."""
    last = _BUCKET_PACKING.get(fn)
    if last is None or not last.holds([(fn, ops, kw)]):
        cls = DirectPacking if fn in _DIRECT_PLAIN else RlePacking
        last = _BUCKET_PACKING[fn] = cls([(fn, ops, kw)])
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
