"""RLE of the MICW strip modes (structure-of-arrays, encode side) and of
the reference formats (interleaved blocks, both sides).

Numpy copies of ``mic_tpu.ops.rle``'s ``RleEncoder``, ``rle_compress``,
``soa_encode``, ``rle_expand``, ``rle_decompress`` and
``rle_decompress_stream`` (same names, same outputs; the decode side
and ``soa_encode`` pinned by ``tests/test_torch_isolation.py``, the
encoder by ``tests/test_torch_host_writers.py``).  The MICW decode side
is the port's device expand (``tpu/post.py:soa_rle_expand``); the
reference formats' blocks expand here, on the host, after the device
entropy decode (``tpu/ref_decode.py``).

The reference grammar over uint16 words, after a leading ``maxValue``
word: a same-run ``[count][value]`` with ``count < midCount``, a
diff-run ``[midCount + k][v1 .. vk]``; ``midCount = (1 << (depth-1)) -
1`` with ``depth = bit_length(maxValue)``.  ``RleEncoder``'s buffered
mode switch (rlecompressu16.go:15-83) defines the bytes: same-runs of
at least 3, a flush two symbols early on count overflow.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RleEncoder", "rle_compress", "soa_encode", "rle_expand", "rle_decompress",
           "rle_decompress_stream"]


class RleEncoder:
    """Streaming RLE encoder replicating the reference state machine exactly
    (rlecompressu16.go:15-83)."""

    __slots__ = ("out", "b", "mid_count", "same")

    def __init__(self, width: int, height: int, max_value: int) -> None:
        depth = int(max_value).bit_length()
        self.mid_count = (1 << (depth - 1)) - 1
        self.out: list[int] = [int(max_value)]
        self.b: list[int] = []
        self.same = False

    def encode(self, symbol: int) -> None:
        b = self.b
        bc = len(b)
        if bc < 2:
            b.append(symbol)
            return
        prev_plus_one = b[bc - 2]
        prev = b[bc - 1]

        if prev_plus_one == prev and prev == symbol:
            if not self.same and bc > 2:
                # Flush the differing prefix, keep the trailing pair.
                self.out.append(self.mid_count + bc - 2)
                self.out.extend(b[: bc - 2])
                del b[: bc - 2]
            self.same = True
        else:
            if self.same and bc > 2:
                self.out.append(bc)
                self.out.append(b[0])
                b.clear()
            self.same = False

        bc = len(b)
        if bc >= self.mid_count - 1:
            if self.same:
                self.out.append(bc - 2)
                self.out.append(b[0])
            else:
                self.out.append(self.mid_count + bc - 2)
                self.out.extend(b[: bc - 2])
            del b[: bc - 2]
        b.append(symbol)

    def flush(self) -> None:
        b = self.b
        bc = len(b)
        if bc > 0:
            if self.same:
                self.out.append(bc)
                self.out.append(b[0])
            else:
                self.out.append(self.mid_count + bc)
                self.out.extend(b)

    def compress(self, data) -> np.ndarray:
        """Standalone compress with a 32-bit length prefix stored as two
        words (rlecompressu16.go:85-93)."""
        data = np.asarray(data, dtype=np.uint16)
        n = len(data)
        self.out.append((n >> 16) & 0xFFFF)
        self.out.append(n & 0xFFFF)
        enc = self.encode
        for v in data.tolist():
            enc(v)
        self.flush()
        return np.array(self.out, dtype=np.uint16)


def rle_compress(data, width: int, height: int, max_value: int) -> np.ndarray:
    """One-shot RLE compress (reference RleCompressU16.Compress)."""
    return RleEncoder(width, height, max_value).compress(data)


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


def rle_expand(stream: np.ndarray, start: int, mid_count: int, n: int | None = None):
    """Expand RLE blocks beginning at ``stream[start]`` into a flat symbol
    array.  Stops after ``n`` symbols if given, else when input exhausts.
    A count <= ``mid_count`` is a same-run (count, value); a count above
    it a literal run of count - mid symbols.  Returns (symbols, index
    after the last block read)."""
    s = np.asarray(stream)
    i = int(start)
    total = len(s)
    out_len = 0
    ordered: list[tuple[bool, int, int]] = []  # (is_same, value|lo, count|hi)
    while i < total and (n is None or out_len < n):
        c = int(s[i])
        i += 1
        if c > mid_count:
            k = c - mid_count
            ordered.append((False, i, i + k))
            i += k
            out_len += k
        else:
            v = int(s[i])
            i += 1
            ordered.append((True, v, c))
            out_len += c
    arrs = []
    for is_same, a, b in ordered:
        if is_same:
            arrs.append(np.full(b, a, dtype=np.uint16))
        else:
            arrs.append(s[a:b].astype(np.uint16))
    if not arrs:
        return np.zeros(0, dtype=np.uint16), i
    out = np.concatenate(arrs)
    if n is not None:
        out = out[:n]
    return out, i


def rle_decompress(stream) -> np.ndarray:
    """One-shot RLE decompress of a Compress()-style stream with the
    leading maxValue word and 32-bit length (reference
    RleDecompressU16.Decompress)."""
    s = np.asarray(stream, dtype=np.uint16)
    max_value = int(s[0])
    depth = max_value.bit_length()
    mid_count = (1 << (depth - 1)) - 1
    out_len = (int(s[1]) << 16) + int(s[2])
    out, _ = rle_expand(s, 3, mid_count, out_len)
    if len(out) != out_len:
        raise ValueError(f"RLE: expected {out_len} symbols, got {len(out)}")
    return out


def rle_decompress_stream(stream) -> tuple[np.ndarray, int]:
    """Expand an RLE stream that has a leading maxValue word but no length
    prefix (the Delta+RLE fused layout, deltarlecompressu16.go:24-67).
    Returns ``(symbols, mid_count)``, symbols being everything after the
    maxValue word, fully expanded."""
    s = np.asarray(stream, dtype=np.uint16)
    max_value = int(s[0])
    depth = max_value.bit_length()
    mid_count = (1 << (depth - 1)) - 1
    out, _ = rle_expand(s, 1, mid_count, None)
    return out, mid_count
