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
* :func:`rans_decode_lanes` — the entropy stage of one bucket: the kernel
  of ``csrc/rans_lanes.cu`` on the card, its plain twin
  :func:`rans_decode_lanes_plain` on the CPU; int16 [S, steps * L] symbols
  in stream order (step, then lane), the layout ``post.post_batch`` reads;
* :class:`LanesPacking` / :func:`rans_decode_lanes_groups` — every scan
  bucket of a plan in one launch;
* :func:`decode_strip_batch` — ``decode_strip_batch_impl`` on its own
  operands: the lanes kernel, then ``post.post_batch``.

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
from .post import post_batch
from .rans_decode import _U32, _as_i16, _check, _Packing, _u

__all__ = [
    "LANES_MAX",
    "build_lane_tables",
    "lane_tensors",
    "rans_decode_lanes",
    "rans_decode_lanes_plain",
    "LanesPacking",
    "rans_decode_lanes_groups",
    "rans_decode_lanes_groups_plain",
    "decode_strip_batch",
]

LANES_MAX = 16384  # csrc/rans_lanes.cu: 1024 threads x 16 lanes a thread
_TABLE_LOG_MAX = 17  # the ncount header's largest tableLog (ops/fse.TABLELOG_ABSOLUTE_MAX)
_THREADS_MAX = 1024
# One bucket's descriptor (csrc/rans_lanes.cu:LaneGroup): the operand
# pointers (init, words, tsym, tfb | tf, tb or 0, toff, tls, counts, escv,
# esides), the element offset of its output, and (lanes, W, E, steps,
# form, 0); form 0: tfb = freq << 16 | bias, 1: tf and tb.
_LANE_GROUP_DESC = np.dtype([("ptr", "<u8", (10,)), ("off", "<i8"), ("arg", "<i4", (6,))])


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


def rans_decode_lanes_plain(init, words, tsym, tf, tb, toff, tls, counts, escv, esides, *,
                            steps: int) -> torch.Tensor:
    """Plain-PyTorch twin of the lanes kernel (any device): ``rans_one``
    and ``subst_one`` of ``decode_strip_batch_impl``, step for step, u32
    held in int64.  Same operands and output as :func:`rans_decode_lanes`."""
    ops = (init, words, tsym, tf, tb, toff, tls, counts, escv, esides)
    S, L, W, E, N = _lanes_operands(*ops, steps)
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
    return _as_i16(torch.where(m, sv, syms))


class LanesPacking(_Packing):
    """The strips of some buckets as the blocks of one launch of the lanes
    kernel, with its descriptors on the device.

    ``groups`` is a list of ``(rans_decode_lanes, operands, {"steps":
    steps})``, checked as the wrapper checks them; outputs are laid out
    group after group in one flat buffer (``out_offs``, ``out_shapes``).
    A block holds one strip and ``threads`` threads (those of the widest
    strip, a thread a lane up to 1024, at least a warp; a narrower strip's
    spare warps leave at once), each thread up to ``lpt`` lanes
    (``threads * lpt`` >= every strip's lanes).  A group whose tables all
    fit 16 bits takes the two-table form (tsym and tfb = tf << 16 | tb),
    else three tables; the kernel reads them from device memory.
    ``blocks`` (int32 [n, 2]: group, strip) runs the longest chains first.
    The packing holds the groups' tensors and the two-table groups' tfb:
    it is valid for those tensors as they were when it was built."""

    def __init__(self, groups):
        if not groups:
            raise ValueError("expected at least one group")
        dev = groups[0][1][0].device
        desc = np.zeros(len(groups), _LANE_GROUP_DESC)
        self.groups, self.out_shapes, self.out_offs = [], [], []
        self._tfb = []  # the two-table groups' tfb, which the descriptors name
        rows, widest, out_at = [], 1, 0
        for g, (fn, ops, kw) in enumerate(groups):
            if fn is not rans_decode_lanes:
                raise ValueError(f"not the lanes wrapper: {fn}")
            if set(kw) != {"steps"}:
                raise ValueError(f"rans_decode_lanes takes steps only, got {sorted(kw)}")
            steps = kw["steps"]
            S, L, W, E, N = _lanes_operands(*ops, steps)
            if ops[0].device != dev:
                raise ValueError(f"group {g} on {ops[0].device}, group 0 on {dev}")
            toff, tls = ops[5].cpu().numpy(), ops[6].cpu().numpy()
            _table_spans(toff, tls, N)
            tf, tb = ops[3], ops[4]
            form = int(bool(((tf >> 16) | (tb >> 16)).any()))
            if form:
                tab = (tf, tb)
            else:
                tab = ((tf << 16) | tb, None)
                self._tfb.append(tab[0])
            ptrs = [ops[0], ops[1], ops[2], tab[0], tab[1], *ops[5:]]
            desc[g] = ([0 if t is None else t.data_ptr() for t in ptrs], out_at,
                       (L, W, E, steps, form, 0))
            rows.append((np.full(S, g), np.arange(S), np.full(S, steps)))
            self.groups.append((fn, tuple(ops), dict(kw)))
            self.out_shapes.append((S, steps * L))
            self.out_offs.append(out_at)
            widest = max(widest, L)
            out_at += S * steps * L
        self.threads = max(32, min(widest, _THREADS_MAX))
        self.lpt = widest // self.threads if widest > self.threads else 1
        self.desc, self.out_total, self.device = desc, out_at, dev
        grp, strip, steps = (np.concatenate(c) for c in zip(*rows))
        o = np.lexsort((strip, grp, -steps))
        self.blocks = np.stack([grp[o], strip[o]], axis=1).astype(np.int32)
        if dev.type == "cuda":
            self.gdesc, self.bdesc = self._upload(self.desc, self.blocks)


def _lanes_launch(packing: LanesPacking, lib=None) -> list[torch.Tensor]:
    """The lanes kernel over a packing's groups, one launch; one output
    per group, views into one flat buffer."""
    dev = packing.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(packing.out_total, dtype=torch.int16, device=dev)
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_lanes_decode_groups(packing.gdesc.data_ptr(), packing.bdesc.data_ptr(),
                                         len(packing.blocks), out.data_ptr(), packing.threads,
                                         packing.lpt, stream)
    if rc != 0:
        raise RuntimeError(f"mic_lanes_decode_groups launch failed: CUDA error {rc}")
    return [out[o:o + S * n].view(S, n) for o, (S, n) in zip(packing.out_offs,
                                                             packing.out_shapes)]


def _launch_shape(packing: LanesPacking, lib=None) -> tuple[int, int]:
    """A packing's launch: (shared-memory bytes a block, blocks resident
    an SM), from the CUDA occupancy query (``chip_smoke.py`` prints it)."""
    import ctypes

    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    out = (ctypes.c_int * 2)()
    rc = lib.mic_lanes_shape(packing.threads, packing.lpt, out)
    if rc != 0:
        raise RuntimeError(f"mic_lanes_shape failed: CUDA error {rc}")
    return tuple(out)


def rans_decode_lanes(init, words, tsym, tf, tb, toff, tls, counts, escv, esides, *,
                      steps: int) -> torch.Tensor:
    """L-lane rANS decode of the S strips of one bucket, escapes
    substituted: int16 [S, steps * L] (bit-view of the u16 symbols, stream
    order: step, then lane; every lane of every step, past a strip's count
    included, as ``mic_tpu``'s scan writes them).

    Operands are :func:`lane_tensors` of :func:`build_lane_tables`' first
    ten arrays.  CPU tensors take :func:`rans_decode_lanes_plain`; CUDA
    tensors launch the kernel of ``csrc/rans_lanes.cu`` for this one bucket
    (a packing built for the call).  ``.launches`` counts the launches."""
    ops = (init, words, tsym, tf, tb, toff, tls, counts, escv, esides)
    if init.device.type == "cpu":
        return rans_decode_lanes_plain(*ops, steps=steps)
    (out,) = _lanes_launch(LanesPacking([(rans_decode_lanes, ops, {"steps": steps})]))
    rans_decode_lanes.launches += 1
    return out


rans_decode_lanes.launches = 0


def rans_decode_lanes_groups_plain(groups) -> list[torch.Tensor]:
    """Plain-PyTorch twin of :func:`rans_decode_lanes_groups`: each
    group's plain twin in turn."""
    return [rans_decode_lanes_plain(*ops, **kw) for _fn, ops, kw in groups]


def rans_decode_lanes_groups(groups, packing: LanesPacking | None = None) -> list[torch.Tensor]:
    """Decode the strips of several buckets of :func:`rans_decode_lanes`
    in one launch.  ``groups`` is a list of ``(rans_decode_lanes,
    operands, {"steps": steps})`` on one device; returns one output per
    group, as the wrapper returns it.  ``packing`` is one built earlier
    for these very tensors (a plan builds it once); without it one is
    built here.  CPU tensors take the plain twin group by group; CUDA
    tensors launch the kernel.  ``.launches`` counts the launches."""
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
    rans_decode_lanes_groups.launches += 1
    return outs


rans_decode_lanes_groups.launches = 0


def decode_strip_batch(init_states, words, tab_sym, tab_freq, tab_bias, counts, n_tokens,
                       n_runs, n_same, esc_vals, esc_sides, *, table_log: int, n_steps: int,
                       width: int, strip_h: int, max_runs: int, max_tokens: int,
                       mid_count: int, delim: int, predictor: str = "zz",
                       device) -> torch.Tensor:
    """``mic_tpu``'s ``decode_strip_batch_impl`` on ``device``: the same
    numpy operands (those of ``build_strip_batch``: init u32 [S, L], words
    [S, W] holding u16 values, slot tables [S, 2^table_log], counts and the
    table entries [S], esc_vals [S], esc_sides u16 [S, E]) and static
    arguments; the lanes kernel (escapes substituted), then
    ``post.post_batch``.  Returns int16 [S, width * strip_h] (bit-view of
    the u16 pixels)."""
    init_states = np.asarray(init_states, np.uint32)
    S, TS = np.shape(tab_sym)
    arrays = (init_states, np.asarray(words).astype(np.uint16),
              np.asarray(tab_sym, np.uint16).reshape(-1),
              np.asarray(tab_freq, np.uint32).reshape(-1),
              np.asarray(tab_bias, np.uint32).reshape(-1),
              (np.arange(S) * TS).astype(np.int32), np.full(S, table_log, np.int32),
              np.asarray(counts, np.int32), np.asarray(esc_vals, np.int32),
              np.asarray(esc_sides, np.uint16))
    ent = rans_decode_lanes(*lane_tensors(arrays, device), steps=int(n_steps))
    meta = torch.tensor(np.stack([n_tokens, n_runs, n_same], axis=1).astype(np.int64),
                        device=device)
    return post_batch(ent, meta[:, 0], meta[:, 1], meta[:, 2], width=width, strip_h=strip_h,
                      max_runs=max_runs, max_tokens=max_tokens, mid_count=mid_count,
                      delim=delim, predictor=predictor)
