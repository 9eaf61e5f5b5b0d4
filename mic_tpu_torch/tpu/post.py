"""The post path of MICW decode: what follows a symbols-out entropy kernel
for the strips the fused kernels do not take.

Counterpart of ``mic_tpu.tpu.pipeline`` (the SoA-RLE expand, the escape
parse and the predictor inverses) and of ``mic_tpu.tpu.strips``'
``_post_one_strip`` / ``_micw_post_batch``.  The JAX package computes
these in plain XLA, so here they are plain torch ops, batched over the
strips of a bucket (a leading axis where JAX vmaps), on whatever device
their input lies.  Each function equals its original on every honest
stream; on a damaged one it stays in bounds (every gather is clamped)
and gives the same output on the CPU and on the card.

Values are int64 tensors holding the u16 symbols; the batch entry point
:func:`post_batch` takes the entropy kernels' int16 bit-view output and
returns int16 bit-views of the u16 pixels, [S, width * strip_h].
"""

from __future__ import annotations

import torch

__all__ = [
    "rle_expand",
    "soa_rle_expand",
    "parse_escaped",
    "zz_delta_inverse",
    "avg_delta_inverse",
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


def rle_expand(stream: torch.Tensor, n_stream: int, mid_count: int, max_out: int):
    """``pipeline.rle_expand_device``: expand one RLE stream of the host
    (interleaved) format, without its leading maxValue word.  ``stream``
    is int [m_pad] (the RLE words, padded), ``n_stream`` the word count.
    Returns (tokens int64 [max_out], n_tokens int64 scalar tensor).

    The block headers are found by pointer doubling over the speculative
    next-header map (p + 2 after a same-run header, p + 1 + literals after
    a literal one), then each output slot takes its run's value or
    literal.  The scatters are ``scatter_reduce`` (amax, the original's
    ``.at[].max``) and ``index_add_`` into a slot past the end for every
    out-of-range position, which the original drops."""
    stream = stream.to(torch.int64)
    m_pad, dev = stream.shape[0], stream.device
    pos = torch.arange(m_pad, device=dev)
    is_same = stream <= mid_count
    nxt = torch.where(is_same, pos + 2, pos + 1 + (stream - mid_count))
    nxt = torch.minimum(nxt, torch.tensor(m_pad, device=dev))
    nxt = torch.where(pos >= n_stream, m_pad - 1, nxt)
    nxt = nxt.clamp(max=m_pad - 1)

    header = torch.zeros(m_pad, dtype=torch.int64, device=dev)
    header[0] = 1
    g = nxt
    for _ in range(max(1, (max(m_pad, 2) - 1).bit_length())):
        header = header.scatter_reduce(0, g, header, reduce="amax", include_self=True)
        g = g[g]
    header = (header > 0) & (pos < n_stream)

    length = torch.where(is_same, stream, stream - mid_count)
    length = torch.where(header, length, 0)
    out_start = torch.cumsum(length, 0) - length
    n_tokens = length.sum()

    marks = torch.zeros(max_out + 2, dtype=torch.int64, device=dev)
    hdr_idx = torch.where(header, out_start, max_out)
    hdr_idx = torch.where((hdr_idx >= 0) & (hdr_idx <= max_out), hdr_idx, max_out + 1)
    marks.index_add_(0, hdr_idx, torch.ones_like(hdr_idx))
    run_id = torch.cumsum(marks[:max_out], 0) - 1

    hdr_rank = torch.cumsum(header.to(torch.int64), 0) - 1
    run_hdr_pos = torch.zeros(m_pad, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(header, hdr_rank, m_pad - 1), pos, reduce="amax", include_self=True)
    run_is_same = is_same[run_hdr_pos]
    run_value = stream[(run_hdr_pos + 1).clamp(max=m_pad - 1)]
    run_out_start = out_start[run_hdr_pos]

    out_idx = torch.arange(max_out, device=dev)
    rid = run_id.clamp(0, m_pad - 1)
    lit_pos = run_hdr_pos[rid] + 1 + (out_idx - run_out_start[rid])
    lit_v = stream[lit_pos.clamp(0, m_pad - 1)]
    tokens = torch.where(run_is_same[rid], run_value[rid], lit_v)
    tokens = torch.where(out_idx < n_tokens, tokens, 0)
    return tokens, n_tokens


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
    Returns int64 [S, height * width] u16 pixels."""
    S, dev = values.shape[0], values.device
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
    those of ``strips._post_params``.  Returns int16 [S, width * strip_h].
    ``.calls`` counts the calls."""
    post_batch.calls += 1
    syms = ent.reshape(ent.shape[0], -1).to(torch.int64) & 0xFFFF
    need = width * strip_h
    if predictor in ("zzd", "vdd", "pdd"):
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
