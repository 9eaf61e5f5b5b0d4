"""The post stage of MICW decode: what follows a symbols-out entropy
kernel for the strips the fused kernels do not take.

Counterpart of ``mic_tpu.tpu.pipeline`` (the SoA-RLE expand, the escape
parse and the predictor inverses) and of ``mic_tpu.tpu.strips``'
``_post_one_strip`` / ``_micw_post_batch``, which the JAX package runs as
one jitted XLA program a bucket.  Here that program is one hand-written
CUDA launch for every post bucket of a plan, ``csrc/post.cu``:

* :class:`PostPacking` — the post stage of a list of buckets, laid out
  once (a plan builds it with its other packings): per bucket its table
  entries (``meta``, int64 [S, 3]: n_tokens, n_runs, n_same) and static
  arguments, the descriptors, the blocks (a block a strip, avg strips
  first), the output and scratch sizes;
* :func:`post_decode_groups` — the entropy outputs of those buckets
  through ``post_groups_kernel`` on the card, one launch for up to
  ``MAX_GROUPS`` buckets (``.launches`` counts them), or through
  :func:`post_batch` bucket by bucket on the CPU; :func:`post_decode` is
  the one-bucket call.

Besides MICW's routes (``PREDICTORS``) the kernel takes one route of the
reference formats, ``avg_i`` (``ROUTES``): a strip of a PICS container or
a single-frame blob, its tANS symbols an interleaved RLE stream (the Init
word, then blocks of a count and a value or a count and its literals,
``ops/rle.py``) whose run headers are found on the card, then the escape
parse and the avg inverse.  The strip's midCount comes from its Init
word and its delimiter from its first token (the image's maxValue), as
``ops/deltarle.py`` reads them, so nothing of a strip's symbols is read
on the host.

:func:`post_batch` is the kernel's plain twin: the functions below in
plain torch ops, batched over the strips of a bucket (a leading axis
where JAX vmaps), on whatever device their input lies.  Each function
equals its original on every honest stream; on a damaged one it stays in
bounds (every gather is clamped), and the kernel keeps the same clamps,
so both give the same output.  ``post_batch.calls`` counts the twin's
calls; a CUDA tensor never takes it.

Values are int64 tensors holding the u16 symbols; the batch entry points
take the entropy kernels' int16 bit-view output and return int16
bit-views of the u16 pixels, [S, width * strip_h].
"""

from __future__ import annotations

import numpy as np
import torch

from .verify import _on

__all__ = [
    "MAX_GROUPS",
    "PREDICTORS",
    "ROUTES",
    "PostPacking",
    "post_decode",
    "post_decode_groups",
    "rle_expand",
    "soa_rle_expand",
    "parse_escaped",
    "zz_delta_inverse",
    "avg_delta_inverse",
    "interleaved_runs",
    "zzd_inverse",
    "vdd_inverse",
    "pdd_inverse",
    "post_batch",
]

_FAR = 1 << 30  # run start past every position (pipeline.py's 2**30)


def _col(v, S: int, device) -> torch.Tensor:
    """A per-strip count ([S], [S, 1] or a scalar) as int64 [S, 1]."""
    return torch.as_tensor(v, dtype=torch.int64, device=device).reshape(-1, 1).expand(S, 1)


def _exclusive(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v, dim=1) - v


def rle_expand(stream: torch.Tensor, n_stream, mid_count, max_out: int):
    """``pipeline.rle_expand_device``: expand one RLE stream of the host
    (interleaved) format, without its leading maxValue word.  ``stream``
    is int [m_pad] (the RLE words, padded), ``n_stream`` the word count.
    Returns (tokens int64 [max_out], n_tokens int64 scalar tensor).  A
    batch of streams [S, m_pad] expands row by row the same way, with
    ``n_stream`` and ``mid_count`` each a number or one a row ([S] or [S,
    1]), and returns ([S, max_out], [S, 1]).

    The block headers are found by pointer doubling over the speculative
    next-header map (p + 2 after a same-run header, p + 1 + literals after
    a literal one), then each output slot takes its run's value or
    literal.  The scatters are ``scatter_reduce`` (amax, the original's
    ``.at[].max``) and ``scatter_add_`` into a slot past the end for every
    out-of-range position, which the original drops."""
    single = stream.dim() == 1
    stream = stream.to(torch.int64).reshape(-1, stream.shape[-1])
    S, m_pad = stream.shape
    dev = stream.device
    n_stream, mid_count = _col(n_stream, S, dev), _col(mid_count, S, dev)
    pos = torch.arange(m_pad, device=dev)[None, :].expand(S, -1)
    is_same = stream <= mid_count
    nxt = torch.where(is_same, pos + 2, pos + 1 + (stream - mid_count))
    nxt = torch.minimum(nxt, torch.tensor(m_pad, device=dev))
    nxt = torch.where(pos >= n_stream, m_pad - 1, nxt)
    nxt = nxt.clamp(max=m_pad - 1)

    header = torch.zeros((S, m_pad), dtype=torch.int64, device=dev)
    header[:, 0] = 1
    g = nxt
    for _ in range(max(1, (max(m_pad, 2) - 1).bit_length())):
        header = header.scatter_reduce(1, g, header, reduce="amax", include_self=True)
        g = torch.gather(g, 1, g)
    header = (header > 0) & (pos < n_stream)

    length = torch.where(is_same, stream, stream - mid_count)
    length = torch.where(header, length, 0)
    out_start = torch.cumsum(length, 1) - length
    n_tokens = length.sum(dim=1, keepdim=True)

    marks = torch.zeros((S, max_out + 2), dtype=torch.int64, device=dev)
    hdr_idx = torch.where(header, out_start, max_out)
    hdr_idx = torch.where((hdr_idx >= 0) & (hdr_idx <= max_out), hdr_idx, max_out + 1)
    marks.scatter_add_(1, hdr_idx, torch.ones_like(hdr_idx))
    run_id = torch.cumsum(marks[:, :max_out], 1) - 1

    hdr_rank = torch.cumsum(header.to(torch.int64), 1) - 1
    run_hdr_pos = torch.zeros((S, m_pad), dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(header, hdr_rank, m_pad - 1), pos, reduce="amax", include_self=True)
    run_is_same = torch.gather(is_same, 1, run_hdr_pos)
    run_value = torch.gather(stream, 1, (run_hdr_pos + 1).clamp(max=m_pad - 1))
    run_out_start = torch.gather(out_start, 1, run_hdr_pos)

    out_idx = torch.arange(max_out, device=dev)[None, :]
    rid = run_id.clamp(0, m_pad - 1)
    lit_pos = (torch.gather(run_hdr_pos, 1, rid) + 1
               + (out_idx - torch.gather(run_out_start, 1, rid)))
    lit_v = torch.gather(stream, 1, lit_pos.clamp(0, m_pad - 1))
    tokens = torch.where(torch.gather(run_is_same, 1, rid), torch.gather(run_value, 1, rid),
                         lit_v)
    tokens = torch.where(out_idx < n_tokens, tokens, 0)
    return (tokens[0], n_tokens[0, 0]) if single else (tokens, n_tokens)


def soa_rle_expand(syms: torch.Tensor, n_runs, n_same, mid_count: int, max_runs: int,
                   max_out: int):
    """``pipeline.soa_rle_expand_device`` over S strips: ``syms`` [S, m]
    (stream order: counts, same-run values, literals).  Returns (tokens
    [S, max_out], n_tokens [S, 1]), both int64."""
    S, m = syms.shape
    dev = syms.device
    n_runs, n_same = _col(n_runs, S, dev), _col(n_same, S, dev)
    r_idx = torch.arange(max_runs, device=dev)[None, :]
    valid_run = r_idx < n_runs
    counts = torch.where(valid_run, torch.gather(syms, 1, r_idx.clamp(max=m - 1).expand(S, -1)),
                         0)
    is_same = valid_run & (counts <= mid_count)
    lengths = torch.where(valid_run, torch.where(is_same, counts, counts - mid_count), 0)
    out_start = _exclusive(lengths)
    n_tokens = lengths.sum(dim=1, keepdim=True)
    si = is_same.to(torch.int64)
    same_rank = _exclusive(si)
    lit_len = torch.where(is_same, 0, lengths)
    lit_start = _exclusive(lit_len)
    value_of_run = torch.gather(syms, 1, (n_runs + same_rank).clamp(0, m - 1))
    lit_base = n_runs + n_same

    # Each output slot's run: the count of run starts <= its position
    # (a branchless binary search; starts are nondecreasing, invalid runs
    # sit at _FAR), as the original does.
    starts = torch.where(valid_run, out_start, _FAR)
    out_idx = torch.arange(max_out, device=dev)[None, :].expand(S, -1)
    cnt = torch.zeros((S, max_out), dtype=torch.int64, device=dev)
    step = 1 << (max_runs - 1).bit_length()
    while step:
        cand = cnt + step
        v = torch.gather(starts, 1, (cand - 1).clamp(max=max_runs - 1))
        cnt = torch.where((cand <= max_runs) & (v <= out_idx), cand, cnt)
        step >>= 1
    rid = (cnt - 1).clamp(0, max_runs - 1)
    lit_pos = lit_base + torch.gather(lit_start, 1, rid) + (out_idx - torch.gather(out_start, 1, rid))
    lit_v = torch.gather(syms, 1, lit_pos.clamp(0, m - 1))
    tokens = torch.where(torch.gather(is_same, 1, rid), torch.gather(value_of_run, 1, rid), lit_v)
    tokens = torch.where(out_idx < n_tokens, tokens, 0)
    return tokens, n_tokens


def parse_escaped(tokens: torch.Tensor, n_tokens, delim: int, n_pixels: int):
    """``pipeline.parse_escaped_device`` over S strips: per-pixel (value,
    is_raw) of an escaped token stream [S, m].  Every maximal run of
    ``delim`` tokens starts at a token boundary, so its even offsets are
    escape markers and the token after each is a raw pixel.

    The token starts are compacted with a cumsum and a scatter where the
    original sorts by rank.  Both give the k-th token start for every k
    below the stream's count of them; past that count (a stream with
    fewer tokens than pixels, which no honest stream is) the original
    takes a position its unstable sort leaves there, and this takes 0."""
    S, m = tokens.shape
    dev = tokens.device
    pos = torch.arange(m, device=dev)[None, :]
    valid = pos < _col(n_tokens, S, dev)
    is_delim = (tokens == delim) & valid
    prev = torch.nn.functional.pad(is_delim[:, :-1], (1, 0), value=False)
    run_start = is_delim & ~prev
    start_pos = torch.cummax(torch.where(run_start, pos, -1), dim=1).values
    marker = is_delim & ((pos - start_pos) % 2 == 0)
    consumed = torch.nn.functional.pad(marker[:, :-1], (1, 0), value=False)
    token_start = ~consumed & valid
    rank = torch.cumsum(token_start.to(torch.int64), dim=1) - 1
    dump = n_pixels  # an extra column that takes every position not kept
    slot = torch.where(token_start & (rank < n_pixels), rank, dump)
    tok_pos = torch.zeros((S, n_pixels + 1), dtype=torch.int64, device=dev)
    tok_pos.scatter_(1, slot, pos.expand(S, -1))
    tok_pos = tok_pos[:, :n_pixels]
    is_raw = torch.gather(marker, 1, tok_pos)
    vals = torch.where(is_raw, torch.gather(tokens, 1, (tok_pos + 1).clamp(max=m - 1)),
                       torch.gather(tokens, 1, tok_pos))
    return vals, is_raw


def _unzigzag(v: torch.Tensor) -> torch.Tensor:
    """ZigZag decode of u16 values held in int64."""
    return (v >> 1) ^ -(v & 1)


def zz_delta_inverse(values: torch.Tensor, is_raw: torch.Tensor, width: int, height: int):
    """``pipeline.zz_delta_inverse_device`` over S strips: the left-delta
    inverse as a segmented row prefix sum that restarts at each escape
    (``torch.cumsum`` plus ``torch.cummax`` of the restart positions).
    Returns int64 [S, height * width] u16 pixels."""
    S = values.shape[0]
    v = values.reshape(S, height, width)
    raw = is_raw.reshape(S, height, width)
    add = torch.where(raw, 0, _unzigzag(v))
    base = torch.where(raw, v, 0)
    xs = torch.arange(width, device=v.device)
    reset = raw | (xs == 0)
    prefix = torch.cumsum(add, dim=2)
    reset_pos = torch.cummax(torch.where(reset, xs, -1), dim=2).values
    rp = reset_pos.clamp(0, width - 1)
    out = torch.gather(base, 2, rp) + prefix - torch.gather(prefix, 2, rp)
    out = out + torch.where((reset_pos == 0) & ~raw[:, :, :1], add[:, :, :1], 0)
    return (out & 0xFFFF).reshape(S, -1)


def avg_delta_inverse(values: torch.Tensor, is_raw: torch.Tensor, thr: int, width: int,
                      height: int):
    """``pipeline.avg_delta_inverse_device`` over S strips: the avg(left,
    top) inverse along anti-diagonal wavefronts k = 2i + j (both
    neighbours lie on earlier wavefronts), over the grid stored skewed,
    B[i, 2i + j] = A[i, j].  The 2(h - 1) + w wavefronts are dependent
    steps, each a few torch ops over every strip of the batch at once.
    ``thr`` is one threshold, or a tensor of one a strip.  Returns int64
    [S, height * width] u16 pixels."""
    S, dev = values.shape[0], values.device
    if isinstance(thr, torch.Tensor):
        thr = thr.reshape(1, S, 1)
    h, w = height, width
    K = 2 * (h - 1) + w
    i_col = torch.arange(h, device=dev)[:, None]
    j = torch.arange(K, device=dev)[None, :] - 2 * i_col  # [h, K]
    jc = j.clamp(0, w - 1)

    def skew(a):  # [S, h, w] -> [K, S, h]: column k of the skewed grid
        return torch.gather(a, 2, jc.expand(S, -1, -1)).permute(2, 0, 1).contiguous()

    v = values.reshape(S, h, w)
    raw = is_raw.reshape(S, h, w)
    valid = ((j >= 0) & (j < w)).T[:, None, :]  # [K, 1, h]
    sk_raw, sk_v = skew(raw), skew(v)
    raw_v = torch.where(sk_raw & valid, sk_v, 0)
    take_pred = ~sk_raw & valid
    diff = sk_v - thr
    # pred = (cl * left + ct * top) >> sh: 0 at the corner, left on row 0,
    # top on column 0, (left + top) >> 1 inside.
    inner_row = (i_col != 0).T  # [1, h]
    inner_col = (j != 0).T[:, None, :]  # [K, 1, h]
    cl = inner_col.to(torch.int64)
    ct = inner_row.to(torch.int64)
    sh = (inner_row & inner_col).to(torch.int64)
    # B[k + 2, s, i + 1] holds wavefront k; row 0 and columns 0-1 are zero.
    B = torch.zeros((K + 2, S, h + 1), dtype=torch.int64, device=dev)
    for k in range(K):
        left = B[k + 1, :, 1:]
        top = B[k, :, :-1]
        pred = (cl[k] * left + ct * top) >> sh[k]
        B[k + 2, :, 1:] = raw_v[k] + take_pred[k] * ((pred + diff[k]) & 0xFFFF)
    idx = (2 * i_col + torch.arange(w, device=dev)[None, :]) + 2  # [h, w]
    grid = B[:, :, 1:].permute(1, 2, 0)  # [S, h, K + 2]
    return torch.gather(grid, 2, idx.expand(S, -1, -1)).reshape(S, -1)


def zzd_inverse(syms: torch.Tensor, width: int, height: int):
    """``pipeline.zzd_inverse_device`` over S strips: unzigzag, then the
    row prefix sum mod 2^16."""
    dz = _unzigzag(syms[:, : width * height]).reshape(-1, height, width)
    return (torch.cumsum(dz, dim=2) & 0xFFFF).reshape(dz.shape[0], -1)


def vdd_inverse(syms: torch.Tensor, width: int, height: int):
    """``pipeline.vdd_inverse_device``: unzigzag, then the column prefix
    sum mod 2^16."""
    dz = _unzigzag(syms[:, : width * height]).reshape(-1, height, width)
    return (torch.cumsum(dz, dim=1) & 0xFFFF).reshape(dz.shape[0], -1)


def pdd_inverse(syms: torch.Tensor, width: int, height: int):
    """``pipeline.pdd_inverse_device``: unzigzag, then the row and the
    column prefix sums, each mod 2^16."""
    dz = _unzigzag(syms[:, : width * height]).reshape(-1, height, width)
    img = torch.cumsum(dz, dim=2) & 0xFFFF
    return (torch.cumsum(img, dim=1) & 0xFFFF).reshape(dz.shape[0], -1)


_DIRECT_INVERSE = {"zzd": zzd_inverse, "vdd": vdd_inverse, "pdd": pdd_inverse,
                   "zzr": zzd_inverse, "vdr": vdd_inverse, "pdr": pdd_inverse}


def _pad_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, n - a.shape[1])) if a.shape[1] < n else a


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """``int.bit_length`` of each element of an int64 tensor of values
    below 2^32."""
    n = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        big = v >= (1 << sh)
        n = n + big * sh
        v = torch.where(big, v >> sh, v)
    return n + (v > 0).to(v.dtype)


def interleaved_runs(cols: int) -> int:
    """The most run headers an interleaved RLE stream of entropy rows of
    ``cols`` symbols can hold (headers lie two words apart or more, the
    last one word on where the walk is clamped): the ``max_runs`` an
    ``avg_i`` bucket must give, which sizes the kernel's runs scratch."""
    return (cols - 1) // 2 + 1


def _interleaved_avg(syms: torch.Tensor, count, width: int, strip_h: int, max_tokens: int):
    """The ``avg_i`` route over S strips: ``syms`` int64 [S, cols] u16
    symbols, each row the Init word and then an interleaved RLE stream
    (``ops/deltarle.py``'s layout), ``count`` each strip's symbol count.
    Per strip, the words r = syms[1:] (W = cols - 1 of them) of which the
    first ``clamp(count - 1, 0, W)`` are the stream; its midCount from the
    Init word v0 (``(1 << (bit_length(v0) - 1)) - 1``, 0 for v0 = 0);
    :func:`rle_expand` to ``max_tokens`` tokens; the delimiter from token
    0 t0 (``(1 << bit_length(t0)) - 1``), the threshold half of it; then
    :func:`parse_escaped` of tokens[1:] and :func:`avg_delta_inverse`.
    Returns int64 [S, width * strip_h] u16 pixels."""
    S, cols = syms.shape
    dev = syms.device
    n_stream = (_col(count, S, dev) - 1).clamp(0, cols - 1)
    v0 = syms[:, :1]
    mid = torch.where(v0 > 0, (1 << (_bit_length(v0) - 1).clamp(min=0)) - 1, 0)
    tokens, n_tok = rle_expand(syms[:, 1:], n_stream, mid, max_tokens)
    delim = (1 << _bit_length(tokens[:, :1])) - 1
    vals, is_raw = parse_escaped(tokens[:, 1:], n_tok - 1, delim, width * strip_h)
    return avg_delta_inverse(vals, is_raw, (delim >> 1).reshape(-1), width, strip_h)


def post_batch(ent: torch.Tensor, n_tokens, n_runs, n_same, *, width: int, strip_h: int,
               max_runs: int, max_tokens: int, mid_count: int, delim: int,
               predictor: str) -> torch.Tensor:
    """``strips._micw_post_batch`` / ``_post_one_strip`` over the S strips
    of a bucket: the entropy output ``ent`` (int16 [S, steps * 128]
    bit-views of u16 symbols) through the direct inverse (zzd / vdd /
    pdd), the SoA-RLE expand and the direct inverse (zzr / vdr / pdr), or
    the expand, the escape parse and the zz or avg inverse (zz, avg;
    token 0 is the strip's maxValue word).  ``n_tokens``, ``n_runs`` and
    ``n_same`` are the strips' table entries; ``mid_count`` and ``delim``
    those of ``strips._post_params``.  The reference formats' route
    ``avg_i`` (:func:`_interleaved_avg`) takes each strip's symbol count
    as ``n_tokens`` and reads its midCount and delimiter from its symbols:
    ``n_runs``, ``n_same``, ``max_runs``, ``mid_count`` and ``delim`` go
    unread.  Returns int16 [S, width * strip_h].  ``.calls`` counts the
    calls."""
    post_batch.calls += 1
    syms = ent.reshape(ent.shape[0], -1).to(torch.int64) & 0xFFFF
    need = width * strip_h
    if predictor == "avg_i":
        pix = _interleaved_avg(syms, n_tokens, width, strip_h, max_tokens)
    elif predictor in ("zzd", "vdd", "pdd"):
        pix = _DIRECT_INVERSE[predictor](_pad_cols(syms, need), width, strip_h)
    else:
        tokens, _nt = soa_rle_expand(syms, n_runs, n_same, mid_count, max_runs, max_tokens)
        if predictor in _DIRECT_INVERSE:
            pix = _DIRECT_INVERSE[predictor](_pad_cols(tokens, need), width, strip_h)
        else:
            S = syms.shape[0]
            vals, is_raw = parse_escaped(tokens[:, 1:], _col(n_tokens, S, syms.device) - 1,
                                         delim, need)
            if predictor == "avg":
                pix = avg_delta_inverse(vals, is_raw, delim >> 1, width, strip_h)
            else:
                pix = zz_delta_inverse(vals, is_raw, width, strip_h)
    return (((pix & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


post_batch.calls = 0


# ---------------------------------------------------------------------------
# The kernel: csrc/post.cu's post_groups_kernel over every post bucket
# ---------------------------------------------------------------------------

PREDICTORS = ("zzd", "vdd", "pdd", "zzr", "vdr", "pdr", "zz", "avg")  # MICW's, post.cu: Pred
ROUTES = PREDICTORS + ("avg_i",)  # and the reference formats' interleaved-RLE avg
MAX_GROUPS = 128  # buckets a launch (post.cu: kMaxGroups)
_RUN_BYTES = 16  # a run in the runs scratch (post.cu: its source and its start)
_KWARGS = ("width", "strip_h", "max_runs", "max_tokens", "mid_count", "delim", "predictor")
_GROUP_DESC = np.dtype([("meta", "<u8"), ("out_off", "<i8"), ("runs_off", "<i8"),
                        ("flags_off", "<i8"), ("width", "<i4"), ("strip_h", "<i4"),
                        ("max_runs", "<i4"), ("max_tokens", "<i4"), ("mid", "<i4"),
                        ("delim", "<i4"), ("pred", "<i4"), ("pad", "<i4")])
_ESCAPED = ("zz", "avg", "avg_i")  # the routes with the escape parse (flag bits a pixel)
_COST = {"avg": 0, "avg_i": 0, "zz": 1}  # block order: the longest chains first


def _static(kw) -> dict:
    """``kw`` as :func:`post_batch`'s keyword arguments, checked: raises
    ValueError for a missing or extra key, a predictor the kernel does
    not know or a size it does not take."""
    if set(kw) != set(_KWARGS):
        raise ValueError(f"post arguments must be {_KWARGS}, got {sorted(kw)}")
    if kw["predictor"] not in ROUTES:
        raise ValueError(f"unknown predictor {kw['predictor']!r} (the kernel takes {ROUTES})")
    ints = {k: kw[k] for k in _KWARGS[:-1]}
    if not all(isinstance(v, (int, np.integer)) for v in ints.values()):
        raise ValueError(f"post arguments must be ints, got {ints}")
    lo = 2 if kw["predictor"] in _ESCAPED else 1  # tokens[1:] holds one at least
    if (kw["width"] < 1 or kw["strip_h"] < 1 or kw["width"] * kw["strip_h"] >= 1 << 31
            or not 1 <= kw["max_runs"] < 1 << 31 or not lo <= kw["max_tokens"] < 1 << 31
            or not -(1 << 31) <= min(kw["mid_count"], kw["delim"])
            or max(kw["mid_count"], kw["delim"]) >= 1 << 31):
        raise ValueError(f"post arguments out of the kernel's range: {ints}")
    return {k: (v if k == "predictor" else int(v)) for k, v in kw.items()}


class PostPacking:
    """The post stage of several buckets, laid out for
    ``post_groups_kernel``.

    ``groups`` is a list of ``(meta, kw)``: a bucket's table entries
    (int64 [S, 3] on ``device``, contiguous: n_tokens, n_runs, n_same a
    strip) and :func:`post_batch`'s keyword arguments.  ``desc`` holds the
    groups' descriptors (``_GROUP_DESC``: output, runs-scratch and
    flags-scratch offsets and the static arguments), ``blocks`` (int32
    [n, 2]: group, strip) a block a strip, ``parts`` the (first group,
    end group, first block, end block) of each launch, ``MAX_GROUPS``
    buckets a launch, the avg strips' blocks first in a launch, then zz,
    then the rest, group numbers counted from the part's first;
    ``interleaved`` says of each part whether it holds an ``avg_i``
    bucket, which the kernel's instance with the interleaved-RLE front end
    takes (MICW's routes alone take the instance without it).
    ``out_total`` (elements), ``runs_total`` (runs: ``max_runs`` a strip
    of the expanding modes, which the kernel uses where a strip's runs
    outgrow its shared memory; an ``avg_i`` bucket's ``max_runs`` a slot of
    ``slots``, the blocks of the interleaved instance resident on the card
    at once, one held by each block whose strip's runs outgrow shared
    memory while it reads them) and ``flags_total`` (32-bit words: a bit a
    pixel of the zz / avg / avg_i strips, used past the kernel's shared
    flag bits) size the output and the scratch.  On a CUDA device the
    descriptors and blocks go to the card here, in one copy from pinned
    memory, queued on the current stream, and ``busy`` (int32 [slots],
    zero) marks the held slots.  Raises ValueError for what the kernel
    does not take."""

    def __init__(self, groups, device):
        self.device = torch.device(device)
        self.metas, self.kws, self.rows = [], [], []
        self.desc = np.zeros(len(groups), _GROUP_DESC)
        out_total = runs_total = flags_total = 0
        self.slots = 1  # one at a time on the CPU (tests/cuda_emu)
        if self.device.type == "cuda" and any(kw.get("predictor") == "avg_i" for _m, kw in groups):
            self.slots = _resident_blocks(self.device)
        for g, (meta, kw) in enumerate(groups):
            kw = _static(kw)
            if (meta.dtype != torch.int64 or meta.dim() != 2 or meta.shape[1] != 3
                    or meta.shape[0] < 1 or not meta.is_contiguous() or not _on(meta, self.device)):
                raise ValueError(f"group {g}: meta must be int64 [S, 3], contiguous, on "
                                 f"{self.device}, got {meta.dtype} {tuple(meta.shape)} on "
                                 f"{meta.device}")
            S, pred = meta.shape[0], kw["predictor"]
            need = kw["width"] * kw["strip_h"]
            self.metas.append(meta)
            self.kws.append(kw)
            self.rows.append(S)
            self.desc[g] = (0, out_total, runs_total, flags_total, kw["width"], kw["strip_h"],
                            kw["max_runs"], kw["max_tokens"], kw["mid_count"], kw["delim"],
                            ROUTES.index(pred), 0)
            out_total += S * need
            if pred == "avg_i":
                runs_total += self.slots * kw["max_runs"]
            elif pred not in ("zzd", "vdd", "pdd"):
                runs_total += S * kw["max_runs"]
            if pred in _ESCAPED:
                flags_total += S * -(-need // 32)
        self.out_total, self.runs_total, self.flags_total = out_total, runs_total, flags_total
        blocks, self.parts, self.interleaved = [], [], []
        for g0 in range(0, len(self.rows), MAX_GROUPS):
            g1, b0 = min(g0 + MAX_GROUPS, len(self.rows)), sum(len(b) for b in blocks)
            for g in sorted(range(g0, g1), key=lambda g: _COST.get(self.kws[g]["predictor"], 2)):
                blocks.append(np.stack([np.full(self.rows[g], g - g0), np.arange(self.rows[g])],
                                       axis=1).astype(np.int32))
            self.parts.append((g0, g1, b0, sum(len(b) for b in blocks)))
            self.interleaved.append(any(kw["predictor"] == "avg_i" for kw in self.kws[g0:g1]))
        self.blocks = np.concatenate(blocks) if blocks else np.zeros((0, 2), np.int32)
        if self.device.type == "cuda":
            self._upload()

    def _upload(self) -> None:
        """Descriptors (the meta pointers filled in) and blocks to the card:
        one device buffer, filled by one non-blocking copy from pinned
        memory."""
        self.desc["meta"] = [m.data_ptr() for m in self.metas]
        gbytes, bbytes = self.desc.nbytes, self.blocks.nbytes
        b_at = -(-gbytes // 16) * 16
        buf = torch.empty(b_at + bbytes, dtype=torch.uint8, device=self.device)
        host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
        raw = host.numpy()
        raw[:gbytes] = self.desc.view(np.uint8)
        raw[b_at:] = self.blocks.view(np.uint8).reshape(-1)
        buf.copy_(host, non_blocking=True)
        self._buf, self._host = buf, host  # the pinned source lives until the copy has run
        self.gdesc_ptr = buf.data_ptr()
        self.bdesc_ptr = buf.data_ptr() + b_at
        self.busy = torch.zeros(self.slots, dtype=torch.int32, device=self.device)

    def holds(self, groups) -> bool:
        """Whether ``groups`` ([(ent, meta, kw)]) are the buckets this
        packing was built for: the same meta tensors and arguments."""
        return len(groups) == len(self.metas) and all(
            m is pm and kw == pkw for (_e, m, kw), pm, pkw in zip(groups, self.metas, self.kws))


def _entropy_rows(ent: torch.Tensor, S: int, device: torch.device, g: int,
                  kw: dict) -> torch.Tensor:
    """A group's entropy output as int16 [S, cols]; raises ValueError unless
    it is int16, [S, ...], contiguous and on ``device``, and, for an
    ``avg_i`` group, of two columns or more with ``max_runs`` at least
    :func:`interleaved_runs` of them (the runs scratch holds every header
    a row can have)."""
    if (ent.dtype != torch.int16 or ent.dim() < 2 or ent.shape[0] != S or ent.numel() == 0
            or not _on(ent, device)):
        raise ValueError(f"group {g}: expected the entropy output int16 [{S}, ...] on {device}, "
                         f"got {ent.dtype} {tuple(ent.shape)} on {ent.device}")
    if not ent.is_contiguous():
        raise ValueError(f"group {g}: the entropy output must be contiguous "
                         f"(strides {ent.stride()})")
    rows = ent.view(S, -1)
    if kw["predictor"] == "avg_i" and (rows.shape[1] < 2
                                       or kw["max_runs"] < interleaved_runs(rows.shape[1])):
        raise ValueError(f"group {g}: an avg_i group of {rows.shape[1]} columns needs two columns "
                         f"or more and max_runs >= {interleaved_runs(rows.shape[1])}, got "
                         f"{kw['max_runs']}")
    return rows


def post_decode_groups(groups, packing: PostPacking | None = None) -> list[torch.Tensor]:
    """The post stage of several buckets in one launch: ``groups`` is a
    list of ``(ent, meta, kw)``, each bucket's entropy output (int16 [S,
    ...], contiguous: the symbols-out kernels' bit-views), its table
    entries and :func:`post_batch`'s keyword arguments; returns one int16
    [S, width * strip_h] output per group, equal to :func:`post_batch`'s.
    ``packing`` is a :class:`PostPacking` built earlier for these buckets
    (a plan builds it once); without it one is built here.  CPU tensors
    take :func:`post_batch` group by group; CUDA tensors launch
    ``post_groups_kernel`` of ``csrc/post.cu``, once per ``MAX_GROUPS``
    buckets, or raise.  ``.launches`` counts the launches."""
    if not groups:
        return []
    if packing is None:
        packing = PostPacking([(m, kw) for _e, m, kw in groups], groups[0][0].device)
    elif not packing.holds(groups):
        raise ValueError("packing was built for other groups")
    ents = [_entropy_rows(e, S, packing.device, g, kw)
            for g, ((e, _m, _kw), S, kw) in enumerate(zip(groups, packing.rows, packing.kws))]
    if packing.device.type == "cpu":
        return [post_batch(e, m[:, 0], m[:, 1], m[:, 2], **kw)
                for e, m, kw in zip(ents, packing.metas, packing.kws)]
    if packing.device.type != "cuda":
        raise ValueError(f"unsupported device {packing.device}")
    outs = _post_launch(packing, ents)
    post_decode_groups.launches += len(packing.parts)
    return outs


def _post_launch(packing: PostPacking, ents, lib=None) -> list[torch.Tensor]:
    """``post_groups_kernel`` over ``packing``'s parts on the entropy
    outputs ``ents`` (int16 [S, cols] on the card, checked by the caller),
    a part with an ``avg_i`` bucket through the kernel's interleaved
    instance (``mic_post_groups_interleaved``),
    from ``lib`` (a library of another form:
    ``scripts/post_design_points.py``) or the kernel library; counts no
    launch.  Returns one int16 [S, width * strip_h] view a group."""
    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    dev = packing.device
    out = torch.empty(packing.out_total, dtype=torch.int16, device=dev)
    scratch = torch.empty(_RUN_BYTES * packing.runs_total + 4 * packing.flags_total + 16,
                          dtype=torch.uint8, device=dev)
    ptrs = np.array([e.data_ptr() for e in ents], np.uint64)
    cols = np.array([e.shape[1] for e in ents], np.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for (g0, g1, b0, b1), inter in zip(packing.parts, packing.interleaved):
            args = (packing.gdesc_ptr + g0 * _GROUP_DESC.itemsize, packing.bdesc_ptr + b0 * 8,
                    b1 - b0, ptrs.ctypes.data + 8 * g0, cols.ctypes.data + 4 * g0, g1 - g0,
                    out.data_ptr(), scratch.data_ptr(),
                    scratch.data_ptr() + _RUN_BYTES * packing.runs_total)
            if inter:
                rc = lib.mic_post_groups_interleaved(*args, packing.busy.data_ptr(),
                                                     packing.slots, stream)
            else:
                rc = lib.mic_post_groups(*args, stream)
            if rc != 0:
                raise RuntimeError(f"mic_post_groups launch failed: CUDA error {rc}")
    outs, off = [], 0
    for S, kw in zip(packing.rows, packing.kws):
        need = kw["width"] * kw["strip_h"]
        outs.append(out[off:off + S * need].view(S, need))
        off += S * need
    return outs


def _launch_shape(lib=None, interleaved: bool = False) -> tuple[int, int, int]:
    """The kernel's launch (of ``lib``, or the kernel library; MICW's
    instance, or the interleaved one): (shared memory bytes a block,
    blocks resident an SM, registers a thread), from the CUDA occupancy
    query."""
    import ctypes

    if lib is None:
        from .._build import kernel_library

        lib = kernel_library()
    out = (ctypes.c_int * 3)()
    rc = lib.mic_post_shape(out, int(interleaved))
    if rc != 0:
        raise RuntimeError(f"mic_post_shape failed: CUDA error {rc}")
    return tuple(out)


def _resident_blocks(device: torch.device) -> int:
    """The blocks of the kernel's interleaved instance resident on
    ``device`` at once: the ``avg_i`` buckets' runs-scratch slots."""
    with torch.cuda.device(device):
        per_sm = _launch_shape(interleaved=True)[1]
        return max(1, per_sm) * torch.cuda.get_device_properties(device).multi_processor_count


post_decode_groups.launches = 0


def post_decode(ent: torch.Tensor, meta: torch.Tensor, **kw) -> torch.Tensor:
    """One bucket's post stage: :func:`post_decode_groups` of ``[(ent,
    meta, kw)]`` (one launch on the card, :func:`post_batch` on the CPU)."""
    return post_decode_groups([(ent, meta, kw)])[0]
