"""Canonical Huffman coder for 16-bit symbols with adaptive symbol subset.

A numpy copy of ``mic_tpu.ops.huffman`` (same names, same bytes; pinned
by ``tests/test_torch_wavelet_huffman_gap.py``).  Reference:
canhuffmancompressu16.go / canhuffmandecompressu16.go.

Design: only the most frequent symbols get Huffman codes (binary search
for the largest prefix of the frequency-sorted alphabet whose max code
length stays <= 14); everything else is escaped through a *delimiter*
code followed by the raw pixel at ``pixelDepth`` bits.  Code lengths come
from the Moffat–Katajainen in-place minimum-redundancy algorithm; codes
are canonical, MSB-first.

Table layout (WriteTable, canhuffmancompressu16.go:119-137)::

    [count u32][maxValue u16][maxCodeLen u8][numSymbols u16]
    [symbols    : numSymbols x pixelDepth bits]
    [codeLengths: numSymbols x bit_length(maxCodeLen) bits]
    [payload    : per symbol, code (+ raw pixelDepth bits after delimiter)]
    [maxCodeLen+pixelDepth zero bits]  (final-window padding)
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriterMSB, ForwardBitReader
from .fse_codec import DECOMPRESS_LIMIT_DEFAULT

__all__ = ["can_huffman_compress", "can_huffman_decompress", "HuffmanTable"]

MAX_CODE_LEN = 14  # OptimizeSymbolCount target (canhuffmancompressu16.go:168-186)


def _moffat_code_lengths(freqs: list[int]) -> list[int]:
    """In-place minimum-redundancy code lengths (Moffat & Katajainen,
    http://www.cs.mu.oz.au/~alistair/inplace.c; reference
    CalculateCodeLengthForGivenSlice, canhuffmancompressu16.go:215-299).

    ``freqs`` must be sorted ascending.  Returns code lengths per entry
    (same order).  For n==1 the single code length is 0.
    """
    f = list(freqs)
    count = len(f)
    if count == 0:
        return []
    if count == 1:
        return [0]

    f[0] += f[1]
    root = 0
    leaf = 2
    for nxt in range(1, count - 1):
        if leaf >= count or f[root] < f[leaf]:
            f[nxt] = f[root]
            f[root] = nxt
            root += 1
        else:
            f[nxt] = f[leaf]
            leaf += 1
        if leaf >= count or (root < nxt and f[root] < f[leaf]):
            f[nxt] += f[root]
            f[root] = nxt
            root += 1
        else:
            f[nxt] += f[leaf]
            leaf += 1

    f[count - 2] = 0
    for nxt in range(count - 3, -1, -1):
        f[nxt] = f[f[nxt]] + 1

    avbl, used, dpth = 1, 0, 0
    root = count - 2
    nxt = count - 1
    while avbl > 0:
        while root >= 0 and f[root] == dpth:
            used += 1
            root -= 1
        while avbl > used:
            f[nxt] = dpth
            nxt -= 1
            avbl -= 1
        avbl = 2 * used
        dpth += 1
        used = 0
    return f


class HuffmanTable:
    """Canonical table shared by encoder and decoder.

    ``symbols``/``lengths`` are in the serialized order (ascending original
    frequency, i.e. longest codes first — the order the Moffat pass leaves
    the list in).  Canonical codes are assigned per the reference's
    symbolStartPerCodeLength walk (canhuffmancompressu16.go:312-344).
    """

    def __init__(self, symbols: np.ndarray, lengths: np.ndarray, max_value: int):
        self.symbols = np.asarray(symbols, dtype=np.uint16)
        self.lengths = np.asarray(lengths, dtype=np.uint8)
        self.max_value = int(max_value)
        self.pixel_depth = max(int(max_value).bit_length(), 1)
        self.delimiter = (1 << self.pixel_depth) - 1
        self.max_code_len = int(self.lengths.max()) if len(self.lengths) else 0
        self.codes = self._assign_codes()

    def _assign_codes(self) -> np.ndarray:
        max_len = self.max_code_len
        per_len = np.bincount(self.lengths, minlength=max_len + 1)
        start = np.zeros(max_len + 1, dtype=np.int64)
        prev = 0
        prev_count = 0
        cur = 0
        for ln in range(1, max_len + 1):
            if per_len[ln] != 0:
                if prev == 0:
                    start[ln] = 0
                else:
                    start[ln] = (start[prev] + prev_count) << (ln - prev)
                prev = ln
                prev_count = per_len[ln]
        next_code = start.copy()
        codes = np.zeros(len(self.symbols), dtype=np.int64)
        for i, ln in enumerate(self.lengths):
            codes[i] = next_code[ln]
            next_code[ln] += 1
        return codes


def _build_table(data: np.ndarray) -> HuffmanTable:
    counts = np.bincount(data)
    max_value = len(counts) - 1
    pixel_depth = max(int(max_value).bit_length(), 1)
    delimiter = (1 << pixel_depth) - 1

    present = np.nonzero(counts)[0]
    present = present[present != delimiter]
    order = np.argsort(counts[present], kind="stable")[::-1]  # freq desc
    syms = present[order]
    freqs = counts[syms]

    # Binary search for the largest prefix with max code length <= 14.
    lo, hi = 0, len(syms)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        cl = _moffat_code_lengths(sorted(freqs[:mid].tolist()))
        if (max(cl) if cl else 0) <= MAX_CODE_LEN:
            lo = mid
        else:
            hi = mid - 1
    syms = syms[:lo]
    freqs = freqs[:lo]

    # Delimiter gets the residual mass; re-sort descending.
    delim_count = int(len(data) - freqs.sum())
    all_syms = np.concatenate([syms, [delimiter]]).astype(np.int64)
    all_freqs = np.concatenate([freqs, [delim_count]]).astype(np.int64)
    order = np.argsort(-all_freqs, kind="stable")
    all_syms, all_freqs = all_syms[order], all_freqs[order]

    # Moffat pass sorts ascending and replaces freq with code length.
    asc = np.argsort(all_freqs, kind="stable")
    sorted_syms = all_syms[asc]
    lengths = _moffat_code_lengths(all_freqs[asc].tolist())
    return HuffmanTable(sorted_syms.astype(np.uint16), np.array(lengths, np.uint8), max_value)


def can_huffman_compress(data) -> bytes:
    """Reference CanHuffmanCompressU16.Compress (canhuffmancompressu16.go:52-81)."""
    data = np.asarray(data, dtype=np.uint16)
    t = _build_table(data)
    if t.pixel_depth + t.max_code_len > 32:
        raise ValueError("pixelDepth + maxCodeLen > 32 bits")

    w = BitWriterMSB()
    w.add_bits(len(data), 32)
    w.add_bits(t.max_value, 16)
    w.add_bits(t.max_code_len, 8)
    w.add_bits(len(t.symbols), 16)
    for s in t.symbols.tolist():
        w.add_bits(int(s), t.pixel_depth)
    len_bits = int(t.max_code_len).bit_length()
    for ln in t.lengths.tolist():
        w.add_bits(int(ln), len_bits)

    # Per-symbol lookup arrays over the full alphabet.
    n_alpha = 1 << t.pixel_depth
    code_of = np.zeros(n_alpha, dtype=np.int64)
    len_of = np.zeros(n_alpha, dtype=np.int64)
    is_delim = np.ones(n_alpha, dtype=bool)
    didx = int(np.nonzero(t.symbols == t.delimiter)[0][0])
    code_of[:] = t.codes[didx]
    len_of[:] = t.lengths[didx]
    m = t.symbols != t.delimiter
    code_of[t.symbols[m]] = t.codes[m]
    len_of[t.symbols[m]] = t.lengths[m]
    is_delim[t.symbols[m]] = False

    sym = data.astype(np.int64)
    esc = is_delim[sym]
    # Interleave: code, then raw pixelDepth bits when escaped.
    sizes = np.where(esc, 2, 1).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    vals = np.zeros(int(sizes.sum()), dtype=np.uint64)
    bits = np.zeros(int(sizes.sum()), dtype=np.uint64)
    vals[starts] = code_of[sym].astype(np.uint64)
    bits[starts] = len_of[sym].astype(np.uint64)
    vals[starts[esc] + 1] = sym[esc].astype(np.uint64)
    bits[starts[esc] + 1] = t.pixel_depth
    w.values.extend(vals.tolist())
    w.widths.extend(bits.tolist())

    # Final zero padding of maxCodeLen+pixelDepth bits.
    w.add_bits(0, t.max_code_len + t.pixel_depth)
    return w.flush_align()


def can_huffman_decompress(blob: bytes, limit: int | None = None) -> np.ndarray:
    """Reference CanHuffmanDecompressU16 (ReadTable + Decompress).

    ``limit`` bounds the declared output count (DecompressLimit analog,
    fse_codec.py) so a corrupt 32-bit header can't drive allocation.
    """
    if limit is None:
        limit = DECOMPRESS_LIMIT_DEFAULT
    r = ForwardBitReader(blob)
    n_out = r.get_bits(32)
    if n_out > limit:
        raise ValueError(f"declared count ({n_out}) > DecompressLimit ({limit})")
    max_value = r.get_bits(16)
    pixel_depth = max(int(max_value).bit_length(), 1)
    delimiter = (1 << pixel_depth) - 1
    max_code_len = r.get_bits(8)
    num_syms = r.get_bits(16)
    symbols = np.array([r.get_bits(pixel_depth) for _ in range(num_syms)], dtype=np.uint16)
    len_bits = int(max_code_len).bit_length()
    lengths = np.array([r.get_bits(len_bits) for _ in range(num_syms)], dtype=np.uint8)

    t = HuffmanTable(symbols, lengths, max_value)

    # Flat decode table over maxCodeLen-bit windows.
    size = 1 << max_code_len
    tab_sym = np.zeros(size, dtype=np.uint16)
    tab_len = np.zeros(size, dtype=np.uint8)
    tab_delim = np.zeros(size, dtype=bool)
    for i in range(num_syms):
        ln = int(lengths[i])
        code = int(t.codes[i]) << (max_code_len - ln)
        span = 1 << (max_code_len - ln)
        tab_sym[code : code + span] = symbols[i]
        tab_len[code : code + span] = ln
        tab_delim[code : code + span] = symbols[i] == delimiter

    ts = tab_sym.tolist()
    tl = tab_len.tolist()
    td = tab_delim.tolist()
    out = np.empty(n_out, dtype=np.uint16)
    get = r.get_bits
    data = r.data
    total_bits = r.total_bits
    pos = r.pos
    mcl = max_code_len
    for i in range(n_out):
        b0 = pos >> 3
        chunk = int.from_bytes(data[b0 : b0 + 6], "big")
        window = (chunk >> (48 - (pos & 7) - mcl)) & ((1 << mcl) - 1)
        ln = tl[window]
        if td[window]:
            pos += ln
            b0 = pos >> 3
            chunk = int.from_bytes(data[b0 : b0 + 6], "big")
            out[i] = (chunk >> (48 - (pos & 7) - pixel_depth)) & ((1 << pixel_depth) - 1)
            pos += pixel_depth
        else:
            out[i] = ts[window]
            pos += ln
    return out
