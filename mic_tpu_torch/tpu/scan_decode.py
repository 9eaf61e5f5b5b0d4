"""The scan tier of MICW decode: L-lane rANS strips at any lane count.

Counterpart of ``mic_tpu.tpu.strips``' scan tier, which ``mic_tpu``'s plan
sends every strip of a container whose lanes are not 128 and every FF 41
strip above tableLog 12 (``strips.py:1896-1898``, ``:1911-1916``):
``decode_strip_batch_impl`` (a ``lax.scan`` over L-lane steps with three
table lookups, ``rans_one``; the escape substitution, ``subst_one``; then
``_post_one_strip``) over the operands of ``build_strip_batch``.

* :func:`build_lane_tables` — the numpy operands of a bucket of parsed
  MICT strips, the counterpart of ``build_strip_batch``: the words padded
  to the bucket's longest stream plus one zero, the escape side streams to
  its longest, FF 57 strips' escape value -1.  The slot tables are flat,
  each strip's at its own tableLog (``toff``, ``tls``), so tableLogs mix
  in a bucket and replicas of one stream share one table;
* :func:`rans_decode_lanes` — one bucket through the kernel of
  ``csrc/rans_lanes.cu`` on the card, its plain twin
  :func:`rans_decode_lanes_plain` on the CPU: int16 [S, steps * L]
  symbols in stream order (step, then lane), the layout the post stage
  (``post.post_decode_groups``) reads, or with ``inverse`` zzd / vdd /
  pdd the pixels, [S, width * strip_h], ``_post_one_strip``'s direct
  branch fused (the warp form of the kernel, strips of up to
  ``WARP_LANES`` lanes);
* :class:`LanesPacking` / :func:`rans_decode_lanes_groups` — every scan
  bucket of a plan in one launch (one a form: the warp form up to
  ``WARP_LANES`` lanes, the block form, symbols out, past it);
  :func:`fused_strip_fits` says which buckets the plan fuses;
* :func:`decode_strip_batch` — ``decode_strip_batch_impl`` on its own
  operands (:func:`build_strip_batch`, a copy of ``mic_tpu``'s): the
  direct predictors fused, every other one through the lanes kernel and
  then the post kernel (``post.post_decode_groups``, one launch; its
  plain twin ``post.post_batch`` on the CPU); its host half
  :func:`strip_batch_host` and its post stage :func:`strip_batch_post`
  are what ``tpu/mesh.py``'s ``decode_strips_sharded`` stages per shard.

Operands are int32 (u32) and int16 (u16) bit-views.  On a damaged stream
the kernel equals the plain twin bit for bit and reads nothing out of
bounds (the word and escape reads clip to their rows, as ``jnp.take``
does with ``mode="clip"``; every table read stays in its strip's table,
which the packing checks); ``mic_tpu`` pads its words and side streams per
group of a different shape, so the garbage it decodes there may differ.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_rans import slot_tables
from .post import _DIRECT_INVERSE, PostPacking, post_decode_groups
from .rans_decode import _U32, _as_i16, _check, _Packing, _round8, _u

__all__ = [
    "LANES_MAX",
    "WARP_LANES",
    "build_lane_tables",
    "lane_tensors",
    "rans_decode_lanes",
    "rans_decode_lanes_plain",
    "LanesPacking",
    "rans_decode_lanes_groups",
    "rans_decode_lanes_groups_plain",
    "fused_strip_fits",
    "build_strip_batch",
    "strip_batch_host",
    "strip_batch_post",
    "decode_strip_batch",
]

LANES_MAX = 16384  # csrc/rans_lanes.cu's block form: 1024 threads x 16 lanes a thread
# Its warp form's widest strip (32 threads x 16 lanes a thread), and the
# strips that take it: fused there, a bucket beats the block form and
# post_batch at every lane count up to it (scripts/lanes_design_points.py).
WARP_LANES = 512
TEAMS = 4  # csrc/rans_lanes.cu:kTeams, strips (warps) a block of the warp form
_TABLE_LOG_MAX = 17  # the ncount header's largest tableLog (ops/fse.TABLELOG_ABSOLUTE_MAX)
_THREADS_MAX = 1024
_RING_SLOTS = 8  # csrc/rans_lanes.cu:kSlots, chunks of max(L, 64) words a ring
_ESC_WINDOW = 1024  # csrc/rans_lanes.cu:kEscWindow, escape values a strip holds
_MAX_BLOCK_BYTES = 232448  # the H100's opt-in shared memory a block (no static use)
_INVERSES = {"zzd": 1, "vdd": 2, "pdd": 3}  # LaneGroup::inv; 0: symbols out
_LANES_KW = {"steps", "inverse", "width", "strip_h"}
# One bucket's descriptor (csrc/rans_lanes.cu:LaneGroup): the operand
# pointers (init, words, tsym, tfb | tf, tb | tfb, toff, tls, counts, escv,
# esides; words and esides with rows padded to 8 values), the element
# offset of its output, and (lanes, W, E, steps, form, inv, out_steps, ws,
# width, wstride, estride, esc); form 0: tfb = freq << 16 | bias, 1: tf
# and tb; inv 0 symbols out, 1 zzd, 2 vdd, 3 pdd; ws = width / lanes; esc:
# a strip of the group has escapes; 8 bytes of padding (144 bytes a
# group).
_LANE_GROUP_DESC = np.dtype([("ptr", "<u8", (10,)), ("off", "<i8"), ("arg", "<i4", (12,)),
                             ("pad", "<i4", (2,))])


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def build_lane_tables(parsed, min_steps: int = 0):
    """The operands of a bucket of parsed MICT strips (``mict_parse``
    outputs, one lane count): (init u32 [S, L], words u16 [S, W], tsym u16
    [N], tf u32 [N], tb u32 [N], toff i32 [S], tls i32 [S], counts i32
    [S], escv i32 [S], esides u16 [S, E], steps).  W is the longest word
    stream plus one zero, E the longest escape side stream (at least 1);
    escv is the escape value of an FF 41 strip with escapes, else -1;
    steps is the longest strip's step count, at least ``min_steps`` and 1.
    Strips that are one parsed object share a table."""
    S = len(parsed)
    L = parsed[0][0]
    if any(p[0] != L for p in parsed):
        raise ValueError("build_lane_tables: strips of several lane counts")
    counts = np.array([p[2] for p in parsed], dtype=np.int64)
    steps = max(1, min_steps, int(max((counts + L - 1) // L)))
    W = max(len(p[4]) for p in parsed) + 1
    E = max([1] + [len(p[7][1]) for p in parsed if p[7] is not None])
    init = np.zeros((S, L), np.uint32)
    words = np.zeros((S, W), np.uint16)
    escv = np.full(S, -1, np.int32)
    esides = np.zeros((S, E), np.uint16)
    toff = np.zeros(S, np.int32)
    tls = np.array([p[1] for p in parsed], np.int32)
    tables, at, seen = [], 0, {}
    for i, p in enumerate(parsed):
        _L, tl, _count, states, wrds, norm, _sl, alias = p
        if id(p) not in seen:
            seen[id(p)] = at
            tables.append(slot_tables(norm, tl, alias)[:3])
            at += 1 << tl
        toff[i] = seen[id(p)]
        init[i] = states
        words[i, : len(wrds)] = wrds
        if alias is not None and len(alias[1]):
            escv[i] = alias[0]
            esides[i, : len(alias[1])] = alias[1]
    tsym, tf, tb = (np.concatenate([t[k] for t in tables]) for k in range(3))
    return (init, words, tsym.astype(np.uint16), tf.astype(np.uint32), tb.astype(np.uint32),
            toff, tls, counts.astype(np.int32), escv, esides, steps)


def lane_tensors(arrays, device) -> tuple[torch.Tensor, ...]:
    """:func:`build_lane_tables`' ten arrays as the wrappers' operands on
    ``device``: int32 bit-views of the 32-bit arrays, int16 of the u16
    ones."""
    view = {2: np.int16, 4: np.int32}
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(view[a.dtype.itemsize]))
                 .to(device) for a in arrays)


def _lanes_operands(init, words, tsym, tf, tb, toff, tls, counts, escv, esides, steps):
    """Checks one bucket's operands; returns (S, L, W, E, N)."""
    if not isinstance(init, torch.Tensor) or init.dim() != 2:
        raise ValueError("init: expected an int32 [S, L] tensor")
    S, L = init.shape
    dev = init.device
    if S < 1 or L < 1 or L & (L - 1) or L > LANES_MAX:
        raise ValueError(f"init: {S} strips of {L} lanes (a power of two <= {LANES_MAX})")
    if not isinstance(steps, int) or steps < 1:
        raise ValueError(f"steps must be a positive int, got {steps!r}")
    if words.dim() != 2 or words.shape[1] < 1 or esides.dim() != 2 or esides.shape[1] < 1:
        raise ValueError("words and esides: expected [S, W] and [S, E], W and E >= 1")
    if tsym.dim() != 1 or tsym.shape[0] < 1:
        raise ValueError("tsym: expected a flat [N] tensor")
    W, E, N = words.shape[1], esides.shape[1], tsym.shape[0]
    _check("init", init, (S, L), dev)
    _check("words", words, (S, W), dev, torch.int16)
    _check("tsym", tsym, (N,), dev, torch.int16)
    for name, t in (("tf", tf), ("tb", tb)):
        _check(name, t, (N,), dev)
    for name, t in (("toff", toff), ("tls", tls), ("counts", counts), ("escv", escv)):
        _check(name, t, (S,), dev)
    _check("esides", esides, (S, E), dev, torch.int16)
    return S, L, W, E, N


def _table_spans(toff: np.ndarray, tls: np.ndarray, N: int) -> None:
    """Every strip's table lies inside the flat tables."""
    if ((tls < 0) | (tls > _TABLE_LOG_MAX)).any():
        raise ValueError(f"tls: tableLogs must be in [0, {_TABLE_LOG_MAX}]")
    end = toff.astype(np.int64) + (np.int64(1) << tls.astype(np.int64))
    if (toff < 0).any() or (end > N).any():
        raise ValueError(f"toff: a strip's table leaves the {N} table slots")


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 of u32 values held in int64 (no int64 overflow)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _lanes_kwargs(L: int, steps: int, inverse=None, width: int = 0, strip_h: int = 0):
    """Checks a call's inverse and geometry; returns (inv code, output
    steps, steps an image row): symbols out (``inverse`` None) keep the
    ``steps`` rows; zzd / vdd / pdd give width * strip_h pixels a strip,
    width a multiple of the lanes."""
    if inverse is None:
        if width or strip_h:
            raise ValueError("width and strip_h go with an inverse")
        return 0, steps, 1
    if inverse not in _INVERSES:
        raise ValueError(f"inverse must be None or one of {sorted(_INVERSES)}, got {inverse!r}")
    if not (isinstance(width, int) and isinstance(strip_h, int) and width > 0 and strip_h > 0):
        raise ValueError(f"an inverse needs positive int width and strip_h, got "
                         f"{width!r}, {strip_h!r}")
    if width % L:
        raise ValueError(f"the {inverse} inverse needs a width that is a multiple of the "
                         f"{L} lanes, got {width}")
    return _INVERSES[inverse], width * strip_h // L, width // L


def _inverse_plain(syms: torch.Tensor, inverse, width: int, strip_h: int) -> torch.Tensor:
    """The fused form's inverse on the symbols-out twin's output (int16
    [S, steps * L]): ``post_batch``'s direct branch, the symbols
    zero-padded (or cut) to width * strip_h, then the inverse."""
    u = syms.to(torch.int64) & 0xFFFF
    need = width * strip_h
    if u.shape[1] < need:
        u = torch.nn.functional.pad(u, (0, need - u.shape[1]))
    return _as_i16(_DIRECT_INVERSE[inverse](u, width, strip_h))


def rans_decode_lanes_plain(init, words, tsym, tf, tb, toff, tls, counts, escv, esides, *,
                            steps: int, inverse=None, width: int = 0,
                            strip_h: int = 0) -> torch.Tensor:
    """Plain-PyTorch twin of the lanes kernel (any device): ``rans_one``
    and ``subst_one`` of ``decode_strip_batch_impl``, step for step, u32
    held in int64, then for an ``inverse`` (zzd, vdd, pdd) its direct
    branch of ``_post_one_strip`` as ``post.post_batch`` runs it.  Same
    operands and output as :func:`rans_decode_lanes`."""
    ops = (init, words, tsym, tf, tb, toff, tls, counts, escv, esides)
    S, L, W, E, N = _lanes_operands(*ops, steps)
    _lanes_kwargs(L, steps, inverse, width, strip_h)
    _table_spans(toff.cpu().numpy(), tls.cpu().numpy(), N)
    dev = init.device
    x = _u(init)
    tl = tls.to(torch.int64)[:, None]
    mask = (1 << tl) - 1
    off = toff.to(torch.int64)[:, None]
    ts, tfs, tbs = tsym.to(torch.int64) & 0xFFFF, _u(tf), _u(tb)
    wd = words.to(torch.int64) & 0xFFFF
    cnt = counts.to(torch.int64)[:, None]
    lane = torch.arange(L, device=dev)[None, :]
    cursor = torch.zeros((S, 1), dtype=torch.int64, device=dev)
    syms = torch.empty((S, steps, L), dtype=torch.int64, device=dev)
    for t in range(steps):
        idx = off + (x & mask)
        syms[:, t] = ts[idx]
        xn = (_mul32(tfs[idx], x >> tl) + tbs[idx]) & _U32
        active = (t * L + lane) < cnt
        need = (xn < (1 << 16)) & active
        ni = need.to(torch.int64)
        k = torch.cumsum(ni, dim=1) - ni
        w = torch.gather(wd, 1, (cursor + k).clamp(max=W - 1))
        xn = torch.where(need, (xn << 16) | w, xn)
        cursor = cursor + ni.sum(dim=1, keepdim=True)
        x = torch.where(active, xn, x)
    syms = syms.reshape(S, -1)
    m = syms == escv.to(torch.int64)[:, None]
    rank = torch.cumsum(m.to(torch.int64), dim=1) - 1
    sv = torch.gather(esides.to(torch.int64) & 0xFFFF, 1, rank.clamp(0, E - 1))
    out = _as_i16(torch.where(m, sv, syms))
    return out if inverse is None else _inverse_plain(out, inverse, width, strip_h)


def _team_bytes(L: int, esc: bool, inv: int, width: int) -> int:
    """Shared bytes of one strip of the warp form (csrc/rans_lanes.cu's
    layout): the word ring, the escape window, the column carry."""
    return (2 * _RING_SLOTS * max(L, 64) + (2 * _ESC_WINDOW if esc else 0)
            + (_round16(2 * width) if inv >= 2 else 0))


def fused_strip_fits(lanes: int, inverse: str, width: int, esc: bool) -> bool:
    """Whether a strip of ``lanes`` lanes and ``width`` pixels a row can
    run the lanes kernel with the ``inverse`` (zzd, vdd, pdd) fused: the
    warp form takes its lanes (``WARP_LANES``), its rows are whole steps
    (width a multiple of the lanes) and its shared memory (ring, escape
    window if ``esc``, column carry) fits a block.  A plan routes a scan
    bucket by this, on every device alike; where it is False the bucket
    runs symbols out and ``post.post_batch``."""
    return (inverse in _INVERSES and lanes <= WARP_LANES and width % lanes == 0
            and _team_bytes(lanes, esc, _INVERSES[inverse], width) <= _MAX_BLOCK_BYTES)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """A [S, n] operand whose rows start 16-byte aligned, as the kernel's
    16-byte copies of a row need: the operand itself where it is
    contiguous, its rows a multiple of 8 values and its first value
    16-byte aligned, else a copy with the rows padded to a multiple of 8
    values (a view at another storage offset included); the padding is
    never read (the clip bounds stay the operand's own)."""
    pad = -t.shape[1] % 8
    if not pad and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], t.shape[1] + pad))
    out[:, :t.shape[1]] = t
    return out


class LanesPacking(_Packing):
    """The strips of some buckets as the launches of the lanes kernel
    (one a form), with its descriptors on the device.

    ``groups`` is a list of ``(rans_decode_lanes, operands, kwargs)``:
    ``steps``, and for a fused group ``inverse``, ``width`` and
    ``strip_h``, checked as the wrapper checks them; outputs are laid out
    group after group in one flat buffer (``out_offs``, ``out_shapes``,
    each group's start a multiple of 8 values).  Strips of up to
    ``warp_lanes`` lanes (``WARP_LANES``; 0 sends every strip to the block
    form) take the warp form: ``teams`` (int32 [n, 4, 3]: group or -1,
    strip and shared byte offset per team) holds 4 consecutive strips a
    block, or fewer where the largest strip leaves no room, longest output
    first; ``smem_bytes`` is a block's largest need (``_team_bytes`` a
    strip).
    Wider strips take the block form, symbols out: ``blocks`` (int32 [n,
    2]: group, strip, most steps first), ``threads`` (the widest such
    strip's, a thread a lane up to 1024, at least a warp) and ``lpt``
    (lanes a thread); a fused group there raises.  ``n_launches`` is 1 or
    2.  A group whose tables all fit 16 bits takes the two-table form
    (tsym and tfb = tf << 16 | tb), else three tables.  The packing holds
    the groups' tensors, the two-table groups' tfb and the padded copies
    of rows whose length is not a multiple of 8: it is valid for those
    tensors as they were when it was built."""

    def __init__(self, groups, *, warp_lanes: int = WARP_LANES):
        if not groups:
            raise ValueError("expected at least one group")
        if not 0 <= warp_lanes <= WARP_LANES:
            raise ValueError(f"warp_lanes must be in [0, {WARP_LANES}], got {warp_lanes}")
        dev = groups[0][1][0].device
        desc = np.zeros(len(groups), _LANE_GROUP_DESC)
        self.groups, self.out_shapes, self.out_offs = [], [], []
        self._keep = []  # tensors the descriptors name: two-table tfb, padded rows
        team_rows, wide_rows, team_bytes = [], [], []
        widest, out_at = 1, 0
        for g, (fn, ops, kw) in enumerate(groups):
            if fn is not rans_decode_lanes:
                raise ValueError(f"not the lanes wrapper: {fn}")
            if "steps" not in kw or set(kw) - _LANES_KW:
                raise ValueError(f"rans_decode_lanes takes steps, inverse, width and strip_h, "
                                 f"got {sorted(kw)}")
            steps = kw["steps"]
            S, L, W, E, N = _lanes_operands(*ops, steps)
            inv, out_steps, ws = _lanes_kwargs(L, steps, kw.get("inverse"),
                                               kw.get("width", 0), kw.get("strip_h", 0))
            if ops[0].device != dev:
                raise ValueError(f"group {g} on {ops[0].device}, group 0 on {dev}")
            toff, tls = ops[5].cpu().numpy(), ops[6].cpu().numpy()
            _table_spans(toff, tls, N)
            tf, tb = ops[3], ops[4]
            form = int(bool(((tf >> 16) | (tb >> 16)).any()))
            tfb = tf if form else (tf << 16) | tb
            words, esides = _strided(ops[1]), _strided(ops[9])
            self._keep += [tfb, words, esides]
            esc = bool((ops[8] >= 0).any())
            ptrs = [ops[0], words, ops[2], tfb, tb if form else tfb, *ops[5:9], esides]
            width = kw.get("width", 0)
            desc[g] = ([t.data_ptr() for t in ptrs], out_at,
                       (L, W, E, steps, form, inv, out_steps, ws, width, words.shape[1],
                        esides.shape[1], int(esc)), (0, 0))
            strips = (np.full(S, g), np.arange(S), np.full(S, out_steps))
            if L <= warp_lanes:
                team_rows.append(strips)
                team_bytes.append(_team_bytes(L, esc, inv, width))
            else:
                if inv:
                    raise ValueError(f"group {g}: the {kw['inverse']} inverse needs the warp "
                                     f"form ({L} lanes, the warp form takes {warp_lanes})")
                wide_rows.append(strips)
                team_bytes.append(0)
                widest = max(widest, L)
            self.groups.append((fn, tuple(ops), dict(kw)))
            self.out_shapes.append((S, out_steps * L))
            self.out_offs.append(out_at)
            out_at += _round8(S * out_steps * L)
        self.desc, self.out_total, self.device = desc, out_at, dev
        self.team_bytes = team_bytes
        self.teams, self.smem_bytes = self._lay_out_teams(team_rows)
        self.blocks = (self._order(wide_rows) if wide_rows
                       else np.zeros((0, 2), np.int32))
        self.threads = max(32, min(widest, _THREADS_MAX))
        self.lpt = widest // self.threads if widest > self.threads else 1
        self.n_launches = int(len(self.teams) > 0) + int(len(self.blocks) > 0)
        if dev.type == "cuda":
            self.gdesc, self.tdesc, self.bdesc = self._upload(self.desc, self.teams, self.blocks)

    @staticmethod
    def _order(rows):
        """(group, strip) pairs, most steps first, then group and strip."""
        grp, strip, steps = (np.concatenate(c) for c in zip(*rows))
        o = np.lexsort((strip, grp, -steps))
        return np.stack([grp[o], strip[o]], axis=1).astype(np.int32)

    def _lay_out_teams(self, rows):
        """The warp form's blocks: ``TEAMS`` consecutive strips a block (in
        :meth:`_order`), or fewer where the largest strip leaves no room."""
        if not rows:
            return np.zeros((0, TEAMS, 3), np.int32), 0
        order = self._order(rows)
        grp = order[:, 0]
        need = np.asarray(self.team_bytes, np.int64)[grp]
        per = min(TEAMS, _MAX_BLOCK_BYTES // int(need.max()))
        if per == 0:
            raise ValueError(f"a strip needs {int(need.max())} bytes of shared memory, a "
                             f"block has {_MAX_BLOCK_BYTES}")
        n = grp.size
        first = np.arange(n) // per * per  # each strip's block's first strip
        at = np.cumsum(need) - need
        at = at - at[first]
        teams = np.full((-(-n // per) * TEAMS, 3), -1, np.int32)
        slot = np.arange(n) // per * TEAMS + np.arange(n) % per
        teams[slot, 0], teams[slot, 1], teams[slot, 2] = grp, order[:, 1], at
        smem = int(np.add.reduceat(need, np.arange(0, n, per)).max())
        return teams.reshape(-1, TEAMS, 3), smem


def _lanes_launch(packing: LanesPacking, lib=None) -> list[torch.Tensor]:
    """The lanes kernel over a packing's groups, one launch a form; one
    output per group, views into one flat buffer.  ``lib`` is another
    build of the kernel library (``scripts/lanes_design_points.py``)."""
    dev = packing.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(packing.out_total, dtype=torch.int16, device=dev)
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if len(packing.teams):
            rc = lib.mic_lanes_decode_groups(packing.gdesc.data_ptr(), packing.tdesc.data_ptr(),
                                             len(packing.teams), out.data_ptr(),
                                             packing.smem_bytes, stream)
            if rc != 0:
                raise RuntimeError(f"mic_lanes_decode_groups launch failed: CUDA error {rc}")
        if len(packing.blocks):
            rc = lib.mic_lanes_decode_wide(packing.gdesc.data_ptr(), packing.bdesc.data_ptr(),
                                           len(packing.blocks), out.data_ptr(), packing.threads,
                                           packing.lpt, stream)
            if rc != 0:
                raise RuntimeError(f"mic_lanes_decode_wide launch failed: CUDA error {rc}")
    return [out[o:o + S * n].view(S, n) for o, (S, n) in zip(packing.out_offs,
                                                             packing.out_shapes)]


def _launch_shape(packing: LanesPacking, wide: bool = False, lib=None) -> tuple[int, int, int]:
    """A packing's launch of one form: (shared-memory bytes a block, blocks
    resident an SM, registers a thread), from the CUDA occupancy query
    (``chip_smoke.py`` prints it)."""
    import ctypes

    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    out = (ctypes.c_int * 3)()
    rc = lib.mic_lanes_shape(int(wide), packing.threads, packing.lpt,
                             0 if wide else max(packing.smem_bytes, 16), out)
    if rc != 0:
        raise RuntimeError(f"mic_lanes_shape failed: CUDA error {rc}")
    return tuple(out)


def rans_decode_lanes(init, words, tsym, tf, tb, toff, tls, counts, escv, esides, *,
                      steps: int, inverse=None, width: int = 0,
                      strip_h: int = 0) -> torch.Tensor:
    """L-lane rANS decode of the S strips of one bucket, escapes
    substituted.  Symbols out (``inverse`` None): int16 [S, steps * L]
    (bit-view of the u16 symbols, stream order: step, then lane; every
    lane of every step, past a strip's count included, as ``mic_tpu``'s
    scan writes them).  With ``inverse`` zzd, vdd or pdd and the strips'
    ``width`` (a multiple of L) and ``strip_h``: int16 [S, width *
    strip_h], the pixels ``post.post_batch`` gives for those symbols
    (zero-padded or cut to width * strip_h, then the inverse).

    Operands are :func:`lane_tensors` of :func:`build_lane_tables`' first
    ten arrays.  CPU tensors take :func:`rans_decode_lanes_plain`; CUDA
    tensors launch the kernel of ``csrc/rans_lanes.cu`` for this one bucket
    (a packing built for the call; strips past ``WARP_LANES`` lanes in its
    block form, which has no inverse).  ``.launches`` counts the
    launches."""
    ops = (init, words, tsym, tf, tb, toff, tls, counts, escv, esides)
    kw = dict(steps=steps)
    if inverse is not None or width or strip_h:
        kw.update(inverse=inverse, width=width, strip_h=strip_h)
    if init.device.type == "cpu":
        return rans_decode_lanes_plain(*ops, **kw)
    packing = LanesPacking([(rans_decode_lanes, ops, kw)])
    (out,) = _lanes_launch(packing)
    rans_decode_lanes.launches += packing.n_launches
    return out


rans_decode_lanes.launches = 0


def rans_decode_lanes_groups_plain(groups) -> list[torch.Tensor]:
    """Plain-PyTorch twin of :func:`rans_decode_lanes_groups`: each
    group's plain twin in turn."""
    return [rans_decode_lanes_plain(*ops, **kw) for _fn, ops, kw in groups]


def rans_decode_lanes_groups(groups, packing: LanesPacking | None = None) -> list[torch.Tensor]:
    """Decode the strips of several buckets of :func:`rans_decode_lanes`
    in one launch a form (one where every strip has at most
    ``WARP_LANES`` lanes).  ``groups`` is a list of ``(rans_decode_lanes,
    operands, kwargs)`` on one device; returns one output per group, as
    the wrapper returns it.  ``packing`` is one built earlier for these
    very tensors (a plan builds it once); without it one is built here.
    CPU tensors take the plain twin group by group; CUDA tensors launch
    the kernel.  ``.launches`` counts the launches."""
    if not groups:
        return []
    devs = {ops[0].device for _fn, ops, _kw in groups}
    if len(devs) > 1:
        raise ValueError(f"groups on several devices: {sorted(map(str, devs))}")
    if groups[0][1][0].device.type == "cpu":
        for fn, ops, kw in groups:
            if fn is not rans_decode_lanes:
                raise ValueError(f"not the lanes wrapper: {fn}")
        return rans_decode_lanes_groups_plain(groups)
    if packing is None:
        packing = LanesPacking(groups)
    elif not packing.holds(groups):
        raise ValueError("packing was built for other groups")
    outs = _lanes_launch(packing)
    rans_decode_lanes_groups.launches += packing.n_launches
    return outs


rans_decode_lanes_groups.launches = 0


def build_strip_batch(parsed, strips, table_log: int, pad_strips_to: int = 0):
    """``mic_tpu``'s ``build_strip_batch``: parsed MICT strips of one
    tableLog and their MICW table entries as :func:`decode_strip_batch`'s
    operands, padded to common shapes.  Returns ``(arrays, meta)``, arrays
    = (init, words, ts, tf, tb, counts, n_tokens, n_runs, n_same,
    esc_vals, esc_sides) and meta = dict(n_steps, max_runs, max_tokens);
    ``pad_strips_to`` appends replicas of strip 0 (a batch that divides a
    mesh).  FF 41 and FF 57 strips mix: esc_vals is -1 for FF 57."""
    S = len(parsed)
    L = parsed[0][0]
    counts = np.array([p[2] for p in parsed], dtype=np.int32)
    n_tokens, n_runs, n_same = (np.array([m[k] for m in strips], dtype=np.int32)
                                for k in (2, 3, 4))
    n_steps = int(max((c + L - 1) // L for c in counts))
    S_pad = max(S, pad_strips_to)
    ts = np.zeros((S_pad, 1 << table_log), dtype=np.uint16)
    tf = np.ones((S_pad, 1 << table_log), dtype=np.uint32)
    tb = np.zeros((S_pad, 1 << table_log), dtype=np.uint32)
    init = np.zeros((S_pad, L), dtype=np.uint32)
    words = np.zeros((S_pad, int(max(len(p[4]) for p in parsed)) + 1), dtype=np.uint32)
    esc_vals = np.full(S_pad, -1, dtype=np.int32)
    esc_sides = np.zeros((S_pad, max([1] + [len(p[7][1]) for p in parsed if p[7] is not None])),
                         dtype=np.uint16)
    for i, (_L, tl, _count, states, wrds, norm, _sl, alias) in enumerate(parsed):
        ts[i], tf[i], tb[i] = slot_tables(norm, tl, alias)[:3]
        init[i] = states
        words[i, : len(wrds)] = wrds
        if alias is not None and len(alias[1]):
            esc_vals[i] = alias[0]
            esc_sides[i, : len(alias[1])] = alias[1]
    if S_pad > S:
        pad = S_pad - S
        counts, n_tokens, n_runs, n_same = (np.concatenate([a, np.full(pad, a[0], np.int32)])
                                            for a in (counts, n_tokens, n_runs, n_same))
        for a in (ts, tf, tb, init, words, esc_vals, esc_sides):
            a[S:] = a[0]
    meta = {"n_steps": n_steps,
            "max_runs": int(-(-(int(n_runs.max()) + 1) // 128) * 128),
            "max_tokens": int(-(-(int(n_tokens.max()) + 1) // 128) * 128)}
    return (init, words, ts, tf, tb, counts, n_tokens, n_runs, n_same, esc_vals,
            esc_sides), meta


def strip_batch_host(init_states, words, tab_sym, tab_freq, tab_bias, counts, n_tokens, n_runs,
                     n_same, esc_vals, esc_sides, *, table_log: int, n_steps: int, width: int,
                     strip_h: int, max_runs: int, max_tokens: int, mid_count: int, delim: int,
                     predictor: str = "zz"):
    """The host half of :func:`decode_strip_batch` on its operands and
    static arguments: (the lanes kernel's ten numpy operands, its keyword
    arguments, the post stage), the inverse fused where
    :func:`fused_strip_fits`, else the post stage (int64 [S, 3] n_tokens,
    n_runs, n_same, and the post stage's keyword arguments); None
    when fused."""
    init_states = np.asarray(init_states, np.uint32)
    S, TS = np.shape(tab_sym)
    arrays = (init_states, np.asarray(words).astype(np.uint16),
              np.asarray(tab_sym, np.uint16).reshape(-1),
              np.asarray(tab_freq, np.uint32).reshape(-1),
              np.asarray(tab_bias, np.uint32).reshape(-1),
              (np.arange(S) * TS).astype(np.int32), np.full(S, table_log, np.int32),
              np.asarray(counts, np.int32), np.asarray(esc_vals, np.int32),
              np.asarray(esc_sides, np.uint16))
    if fused_strip_fits(init_states.shape[1], predictor, width, bool((arrays[8] >= 0).any())):
        return arrays, dict(steps=int(n_steps), inverse=predictor, width=width,
                            strip_h=strip_h), None
    meta = np.stack([n_tokens, n_runs, n_same], axis=1).astype(np.int64)
    return arrays, dict(steps=int(n_steps)), (meta, dict(
        width=width, strip_h=strip_h, max_runs=max_runs, max_tokens=max_tokens,
        mid_count=mid_count, delim=delim, predictor=predictor))


def strip_batch_post(out: torch.Tensor, post, packing: PostPacking | None = None) -> torch.Tensor:
    """The post stage of :func:`strip_batch_host` on the lanes kernel's
    output (``post`` with its meta on the output's device): one launch of
    the post kernel (``post.post_decode_groups``, with ``packing`` where one
    was built for ``[post]``), or the output itself when fused."""
    if post is None:
        return out
    meta, kw = post
    return post_decode_groups([(out, meta, kw)], packing)[0]


def decode_strip_batch(init_states, words, tab_sym, tab_freq, tab_bias, counts, n_tokens,
                       n_runs, n_same, esc_vals, esc_sides, *, table_log: int, n_steps: int,
                       width: int, strip_h: int, max_runs: int, max_tokens: int,
                       mid_count: int, delim: int, predictor: str = "zz",
                       device) -> torch.Tensor:
    """``mic_tpu``'s ``decode_strip_batch_impl`` on ``device``: the same
    numpy operands (those of ``build_strip_batch``: init u32 [S, L], words
    [S, W] holding u16 values, slot tables [S, 2^table_log], counts and the
    table entries [S], esc_vals [S], esc_sides u16 [S, E]) and static
    arguments.  The direct predictors (zzd, vdd, pdd) take the lanes
    kernel with their inverse fused where :func:`fused_strip_fits`; every
    other batch the lanes kernel (escapes substituted), then the post
    kernel (:func:`strip_batch_post`).  Returns int16 [S, width *
    strip_h] (bit-view of the u16 pixels)."""
    arrays, kw, post = strip_batch_host(
        init_states, words, tab_sym, tab_freq, tab_bias, counts, n_tokens, n_runs, n_same,
        esc_vals, esc_sides, table_log=table_log, n_steps=n_steps, width=width,
        strip_h=strip_h, max_runs=max_runs, max_tokens=max_tokens, mid_count=mid_count,
        delim=delim, predictor=predictor)
    out = rans_decode_lanes(*lane_tensors(arrays, device), **kw)
    if post is not None:
        post = (torch.from_numpy(post[0]).to(device), post[1])
    return strip_batch_post(out, post)
