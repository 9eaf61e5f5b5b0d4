"""Structure-of-arrays RLE of the MICW strip modes, encode side.

A numpy copy of ``mic_tpu.ops.rle.soa_encode`` (same name, same output;
pinned by ``tests/test_torch_isolation.py``).  The decode side is the
port's device expand (``tpu/post.py:soa_rle_expand``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["soa_encode"]


def soa_encode(tokens, mid_count: int, min_same: int = 3):
    """Token stream -> structure-of-arrays RLE ``(soa_symbols, n_runs,
    n_same)``: the counts section (count <= mid = same-run of that
    length, count > mid = literal run of count - mid symbols), then the
    same-run values, then the literals.  Same-run blocks take runs of at
    least ``min_same``, split into <= mid chunks (evenly when ``min_same``
    > 3, so every chunk keeps >= min_same); everything between becomes
    literal blocks of at most mid - 1 symbols."""
    t = np.asarray(tokens, dtype=np.uint16)
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.uint16), 0, 0
    mid = int(mid_count)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(t[1:], t[:-1], out=change[1:])
    starts = np.nonzero(change)[0]
    lens = np.diff(np.append(starts, n))
    vals = t[starts]
    is_same = lens >= min_same

    # Group consecutive non-same runs into literal stretches.
    grp = np.cumsum(is_same)
    lit_mask = ~is_same
    lit_grp = grp[lit_mask]
    lit_lens_runs = lens[lit_mask]
    lit_starts_runs = starts[lit_mask]
    if len(lit_grp):
        first = np.empty(len(lit_grp), dtype=bool)
        first[0] = True
        np.not_equal(lit_grp[1:], lit_grp[:-1], out=first[1:])
        stretch_first = np.nonzero(first)[0]
        stretch_start = lit_starts_runs[stretch_first]
        stretch_len = np.add.reduceat(lit_lens_runs, stretch_first)
    else:
        stretch_start = np.zeros(0, dtype=np.int64)
        stretch_len = np.zeros(0, dtype=np.int64)

    same_idx = np.nonzero(is_same)[0]
    same_start = starts[same_idx]
    same_len = lens[same_idx]
    same_val = vals[same_idx]

    lit_cap = max(1, mid - 1)
    blocks = []  # (start_pos, kind, a, b): kind 0 same (len, val), 1 literal (lo, hi)
    for s0, ln, v in zip(same_start.tolist(), same_len.tolist(), same_val.tolist()):
        if min_same > 3 and ln > mid:
            k = -(-ln // mid)
            base, rem = divmod(ln, k)
            for j in range(k):
                c = base + (1 if j < rem else 0)
                blocks.append((s0, 0, c, v))
                s0 += c
            continue
        while ln > 0:
            c = min(ln, mid)
            blocks.append((s0, 0, c, v))
            s0 += c
            ln -= c
    for s0, ln in zip(stretch_start.tolist(), stretch_len.tolist()):
        while ln > 0:
            c = min(ln, lit_cap)
            blocks.append((s0, 1, s0, s0 + c))
            s0 += c
            ln -= c
    blocks.sort(key=lambda b: b[0])

    counts = np.empty(len(blocks), dtype=np.uint16)
    same_vals = []
    lit_spans = []
    for i, (_s0, kind, a, b) in enumerate(blocks):
        if kind == 0:
            counts[i] = a
            same_vals.append(b)
        else:
            counts[i] = mid + (b - a)
            lit_spans.append((a, b))
    lits = (
        np.concatenate([t[a:b] for a, b in lit_spans])
        if lit_spans
        else np.zeros(0, dtype=np.uint16)
    )
    soa = np.concatenate(
        [counts, np.array(same_vals, dtype=np.uint16), lits.astype(np.uint16)]
    )
    return soa, len(counts), len(same_vals)
