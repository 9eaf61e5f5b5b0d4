"""The benchmark's plain reference of the PICS format: a decoder of the MIC
reference's parallel-strip containers (``parallelstrips.go``) in NumPy
alone.

A PICS container is ``"PICS"``, width, height, strip count and strip
height (u32 each), an offset table of (offset, length) a strip, then the
strips, each a single-frame blob (``multiframecompress.go``): the
delta + RLE stream (``deltarlecompressu16.go``) under an FSE coder of 2,
4 or 8 interleaved states (magic FF 02 / FF 04 / FF 84 and a u32 symbol
count) or of one state (no magic).  The symbols are the Init word (the
delimiter of the pixel depth, from which the RLE midCount comes), then
RLE blocks, a count <= midCount and a value or a count above it and
count - midCount literals; the expanded tokens are the image's maxValue
and the escaped avg residuals (a delimiter at an even offset of its run
of delimiters escapes the raw pixel after it), which the avg(left, top)
predictor inverts.

The entropy decode runs every strip of a container and every state at
once, one step of N symbols at a time; the avg inverse runs a container's
strips of one shape at once, one anti-diagonal at a time.  It imports
nothing of the program: the benchmark judges the program's decode with
it.  The normalized-count header, the escape parse and the delimiter
arithmetic are ``reference.py``'s.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference import delta_params, parse_escaped, read_ncount

PICS_MAGIC = b"PICS"
PICS_HEADER = 20
N_STATES = {b"\xff\x02": 2, b"\xff\x04": 4, b"\xff\x84": 8}


def pics_strips(blob: bytes):
    """(width, height, [(first row, rows, strip blob)]) of a container."""
    if len(blob) < PICS_HEADER or blob[:4] != PICS_MAGIC:
        raise ValueError("PICS: bad magic")
    width, height, n_strips, strip_h = struct.unpack_from("<IIII", blob, 4)
    table = PICS_HEADER + 8 * n_strips
    if not (width and height and n_strips and strip_h) or len(blob) < table:
        raise ValueError("PICS: bad header")
    strips = []
    for s in range(n_strips):
        off, length = struct.unpack_from("<II", blob, PICS_HEADER + 8 * s)
        if table + off + length > len(blob):
            raise ValueError(f"PICS: strip {s} past the end")
        y0 = s * strip_h
        strips.append((y0, min(strip_h, height - y0), blob[table + off:table + off + length]))
    return width, height, strips


def decode_tables(norm: np.ndarray, symbol_len: int, table_log: int):
    """(symbol, next state base, bits) of every state of a tANS table: the
    symbols spread over the table (low-probability symbols, norm -1, one
    slot each from the top down; the others by the step (size / 2 + size
    / 8 + 3) walk that skips the top), then each symbol's slots in table
    order numbered from its count up, x, reading tableLog - floor(log2 x)
    bits onto (x << bits) - size."""
    size = 1 << table_log
    norm = np.asarray(norm[:symbol_len], np.int64)
    table = np.zeros(size, np.int64)
    low = np.nonzero(norm == -1)[0]
    table[size - 1 - np.arange(low.size)] = low
    top = size - 1 - low.size
    walk = (np.arange(size) * ((size >> 1) + (size >> 3) + 3)) & (size - 1)
    walk = walk[walk <= top]  # the step walk skipping the top, in order
    count = np.where(norm == -1, 1, np.maximum(norm, 0))
    if int(np.maximum(norm, 0).sum()) != walk.size:
        raise ValueError("FSE: the spread does not close")
    table[walk] = np.repeat(np.arange(symbol_len), np.maximum(norm, 0))
    order = np.argsort(table, kind="stable")  # each symbol's slots in table order
    first = np.concatenate([[0], np.cumsum(count)])[:-1]
    x = np.empty(size, np.int64)
    x[order] = np.arange(size) - first[table[order]] + count[table[order]]
    bits = table_log - np.floor(np.log2(x)).astype(np.int64)
    return table, (x << bits) - size, bits


def _stream(blob: bytes):
    """(states, count or None, tables, bitstream) of an entropy blob."""
    n, count, body = 1, None, blob
    if blob[:2] in N_STATES and len(blob) >= 6:
        n, count, body = N_STATES[blob[:2]], int.from_bytes(blob[2:6], "little"), blob[6:]
    norm, symbol_len, table_log, used = read_ncount(body)
    bits = body[used:]
    if not bits or bits[-1] == 0:
        raise ValueError("FSE: no end mark")
    return n, count, table_log, decode_tables(norm, symbol_len, table_log), bits


def _windows(bits: bytes) -> np.ndarray:
    """u64 [len(bits)]: the 8 bytes from each byte on, little-endian."""
    b = np.frombuffer(bits + bytes(8), np.uint8).astype(np.uint64)
    return sum(b[k:k + len(bits)] << np.uint64(8 * k) for k in range(8))


def _decode_one_state(table_log, tables, bits: bytes) -> np.ndarray:
    """A 1-state stream, one symbol at a time, to the stream's end mark."""
    sym, base, nb = (t.tolist() for t in tables)
    data = int.from_bytes(bits, "little")
    pos = 8 * (len(bits) - 1) + bits[-1].bit_length() - 1

    def get(n):
        nonlocal pos
        pos -= n
        return (data >> pos) & ((1 << n) - 1) if pos >= 0 else (data << -pos) & ((1 << n) - 1)

    x, out = get(table_log), []
    while True:
        if pos <= 0 and nb[x] > 0:
            if x:
                out.append(sym[x])
            return np.asarray(out, np.int64)
        out.append(sym[x])
        x = base[x] + get(nb[x])


def decode_entropy(blobs) -> list[np.ndarray]:
    """Each blob's symbols (int64).  The streams of 2, 4 or 8 states
    decode together, a step at a time: lane j of a stream emits symbol t
    * N + j from its state, then reads its bits below those of lanes < j
    from the stream's top down."""
    out, batch = [None] * len(blobs), []
    for i, blob in enumerate(blobs):
        n, count, table_log, tables, bits = _stream(blob)
        if count is None:
            out[i] = _decode_one_state(table_log, tables, bits)
        else:
            batch.append((i, n, count, table_log, tables, bits))
    if not batch:
        return out
    lanes = max(b[1] for b in batch)
    S = len(batch)
    sym = np.concatenate([b[4][0] for b in batch])
    base = np.concatenate([b[4][1] for b in batch])
    nb = np.concatenate([b[4][2] for b in batch])
    t_at = np.concatenate([[0], np.cumsum([len(b[4][0]) for b in batch])])[:-1, None]
    win = np.concatenate([_windows(b[5]) for b in batch])
    w_at = np.concatenate([[0], np.cumsum([len(b[5]) for b in batch])])[:-1, None]
    n_of = np.array([b[1] for b in batch])[:, None]
    count = np.array([b[2] for b in batch])[:, None]
    pos = np.array([8 * (len(b[5]) - 1) + b[5][-1].bit_length() - 1 for b in batch])[:, None]
    lane = np.arange(lanes)[None, :]
    live = lane < n_of

    def read(q, n):  # n bits at bit q of each stream (0 below bit 0)
        qc = np.maximum(q, 0)
        v = (win[w_at + (qc >> 3)] >> (qc & 7).astype(np.uint64)).astype(np.int64)
        return np.where(q >= 0, v & ((1 << n) - 1), 0)

    tl = np.array([b[3] for b in batch])[:, None]
    cum = np.cumsum(np.where(live, tl, 0), axis=1)
    state = read(pos - cum, tl)  # the initial states, lane 0's bits on top
    pos = pos - cum[:, -1:]
    steps = int((-(-count // n_of)).max())
    syms = np.zeros((S, steps, lanes), np.int64)
    for t in range(steps):
        active = live & (t * n_of + lane < count)
        at = t_at + state
        syms[:, t] = sym[at]
        bits = np.where(active, nb[at], 0)
        cum = np.cumsum(bits, axis=1)
        state = np.where(active, base[at] + read(pos - cum, bits), state)
        pos = pos - cum[:, -1:]
    for k, (i, n, c, *_rest) in enumerate(batch):
        out[i] = syms[k, :, :n].reshape(-1)[:c]
    return out


def rle_tokens(symbols: np.ndarray) -> np.ndarray:
    """The tokens of an RLE stream after its Init word: a count <=
    midCount and a value, or a count above it and count - midCount
    literals, to the stream's end."""
    s = np.asarray(symbols, np.int64)
    mid = (1 << (int(s[0]).bit_length() - 1)) - 1
    parts, i = [], 1
    while i < len(s):
        c = int(s[i])
        if c > mid:
            parts.append(s[i + 1:i + 1 + c - mid])
            i += 1 + c - mid
        else:
            parts.append(np.full(c, s[i + 1] if i + 1 < len(s) else 0, np.int64))
            i += 2
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def avg_inverse(values: np.ndarray, raw: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """The avg(left, top) inverse of S strips of one shape at once:
    ``values`` and ``raw`` [S, h, w], ``thr`` [S]; pixel = pred + value -
    thr mod 2^16 (pred 0 at the corner, left on the first row, top on the
    first column, (left + top) >> 1 inside), or the value where raw; by
    anti-diagonals k = i * 2 + j, whose neighbours lie on earlier ones."""
    S, h, w = values.shape
    out = np.zeros((S, h, w), np.int64)
    d = values.astype(np.int64) - thr[:, None, None]
    for k in range(2 * (h - 1) + w):
        i = np.arange(max(0, (k - w + 2) // 2), min(h - 1, k // 2) + 1)
        j = k - 2 * i
        keep = (j >= 0) & (j < w)
        i, j = i[keep], j[keep]
        left = np.where(j > 0, out[:, i, np.maximum(j - 1, 0)], 0)
        top = np.where(i > 0, out[:, np.maximum(i - 1, 0), j], 0)
        pred = np.where(i == 0, left, np.where(j == 0, top, (left + top) >> 1))
        out[:, i, j] = np.where(raw[:, i, j], values[:, i, j], (pred + d[:, i, j]) & 0xFFFF)
    return out


def decode_pics(blob: bytes) -> tuple[np.ndarray, int, int]:
    """A PICS container's pixels: (u16 [height * width], width, height)."""
    width, height, strips = pics_strips(blob)
    symbols = decode_entropy([data for _y0, _h, data in strips])
    by_shape: dict = {}
    for (y0, rows, _data), syms in zip(strips, symbols):
        tokens = rle_tokens(syms)
        if not tokens.size:
            raise ValueError("PICS: a strip without tokens")
        thr, delim = delta_params(int(tokens[0]))
        values, raw = parse_escaped(tokens[1:], delim, width * rows)
        by_shape.setdefault(rows, []).append((y0, values, raw, thr))
    out = np.empty((height, width), np.uint16)
    for rows, items in by_shape.items():
        values = np.stack([v for _y, v, _r, _t in items]).reshape(-1, rows, width)
        raw = np.stack([r for _y, _v, r, _t in items]).reshape(-1, rows, width)
        px = avg_inverse(values.astype(np.int64), raw, np.array([t for *_a, t in items]))
        for (y0, *_rest), p in zip(items, px):
            out[y0:y0 + rows] = p
    return out.ravel(), width, height
