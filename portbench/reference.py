"""The benchmark's plain reference: a MICW decoder in NumPy alone.

It reads a MICW container (the format ``mic_tpu_torch.tpu.strips`` writes)
and returns its pixels, one strip and one rANS step at a time: the
normalized-count header, the FF 57 (standard) and FF 41 (alias-mapped)
rANS streams at any lane count, SoA-RLE, the escape parse and the zz /
avg / direct inverses, raw and constant strips, column bands.  It imports
nothing of the program: the benchmark judges the program's decode with
it, so it must not share the program's code or tables.  It follows the
format's host decoder line for line where the arithmetic is the format's.
"""

from __future__ import annotations

import struct

import numpy as np

MICW_MAGIC = b"MICW"
MICW_HEADER = 24
MICW_ENTRY = 28
FLAG_AVG_PREDICTOR = 0x01
FLAG_DIRECT = 0x02
FLAG_BANDED = 0x08
MODE_MICT, MODE_RAW, MODE_CONST = 0, 1, 5
MODE_PRED = {2: "zzd", 3: "zz", 4: "avg", 6: "vdd", 7: "pdd", 8: "zzr", 9: "vdr", 10: "pdr"}
MID_DIRECT = 16383  # the r-modes' RLE midCount
MICT_MAGIC = b"\xffW"
MICT_ALIAS_MAGIC = b"\xffA"
RANS_L = 1 << 16
MIN_TABLE_LOG = 5
TABLELOG_ABSOLUTE_MAX = 17
MAX_SYMBOL_VALUE = 65535


def delta_params(max_value: int) -> tuple[int, int]:
    """(delta threshold, escape delimiter) of a maxValue."""
    depth = int(max_value).bit_length()
    return (1 << (depth - 1)) - 1, (1 << depth) - 1


def rle_mid(max_value: int) -> int:
    """MICW's RLE midCount of the escaped modes: from the delimiter,
    floored at 127."""
    delim = max(delta_params(max_value)[1], 255)
    return (1 << (delim.bit_length() - 1)) - 1


def read_ncount(data: bytes):
    """The FSE normalized-count header: (norm, symbol_len, table_log,
    bytes consumed)."""
    iend = len(data)
    if iend < 4:
        raise ValueError("ncount: input too small")

    def u32(off: int) -> int:
        return int.from_bytes(data[off:off + 4], "little")

    off = 0
    bit_stream = u32(0)
    nb_bits = (bit_stream & 0xF) + MIN_TABLE_LOG
    if nb_bits > TABLELOG_ABSOLUTE_MAX:
        raise ValueError("ncount: tableLog too large")
    bit_stream >>= 4
    bit_count = 4
    table_log = nb_bits
    remaining = (1 << nb_bits) + 1
    threshold = 1 << nb_bits
    got_total = 0
    nb_bits += 1
    norm = np.zeros(MAX_SYMBOL_VALUE + 1, dtype=np.int64)
    charnum = 0
    previous0 = False
    while remaining > 1:
        if previous0:
            n0 = charnum
            while (bit_stream & 0xFFFF) == 0xFFFF:
                n0 += 24
                if off < iend - 5:
                    off += 2
                    bit_stream = u32(off) >> bit_count
                else:
                    bit_stream >>= 16
                    bit_count += 16
            while (bit_stream & 3) == 3:
                n0 += 3
                bit_stream >>= 2
                bit_count += 2
            n0 += bit_stream & 3
            bit_count += 2
            if n0 > MAX_SYMBOL_VALUE:
                raise ValueError("ncount: maxSymbolValue too small")
            charnum = max(charnum, n0)
            if off <= iend - 7 or off + (bit_count >> 3) <= iend - 4:
                off += bit_count >> 3
                bit_count &= 7
                bit_stream = u32(off) >> bit_count
            else:
                bit_stream >>= 2
        maxv = (2 * threshold - 1) - remaining
        if (bit_stream & (threshold - 1)) < maxv:
            count = bit_stream & (threshold - 1)
            bit_count += nb_bits - 1
        else:
            count = bit_stream & (2 * threshold - 1)
            if count >= threshold:
                count -= maxv
            bit_count += nb_bits
        count -= 1
        if count < 0:
            remaining += count
            got_total -= count
        else:
            remaining -= count
            got_total += count
        norm[charnum & 0xFFFF] = count
        charnum += 1
        previous0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if off <= iend - 7 or off + (bit_count >> 3) <= iend - 4:
            off += bit_count >> 3
            bit_count &= 7
        else:
            bit_count -= 8 * (iend - 4 - off)
            off = iend - 4
        bit_stream = u32(off) >> (bit_count & 31)
    if not 1 < charnum <= MAX_SYMBOL_VALUE + 1:
        raise ValueError(f"ncount: symbolLen {charnum}")
    if remaining != 1 or bit_count > 32 or got_total != (1 << table_log):
        raise ValueError("ncount: corrupt header")
    off += (bit_count + 7) >> 3
    return norm[:charnum].copy(), charnum, table_log, off


def _freqs(norm: np.ndarray) -> np.ndarray:
    """Slot frequencies: a low-probability (-1) symbol holds one slot."""
    return np.where(norm == -1, 1, np.maximum(norm, 0)).astype(np.int64)


def standard_tables(norm: np.ndarray, table_log: int):
    """(symbol, frequency, bias) of every slot of an FF 57 stream: the
    symbols in ascending order, each over ``freq`` consecutive slots."""
    freqs = _freqs(norm)
    if int(freqs.sum()) != 1 << table_log:
        raise ValueError("MICT: frequencies do not fill the table")
    cumul = np.concatenate(([0], np.cumsum(freqs)))[:-1]
    present = np.nonzero(freqs)[0]
    sym = np.repeat(present, freqs[present])
    slot = np.arange(1 << table_log)
    return sym, freqs[sym], slot - cumul[sym]


def alias_tables(norm: np.ndarray, table_log: int):
    """(symbol, frequency, bias) of every slot of an FF 41 stream: the
    slots in 128 buckets of K = 2^(tl-7), each a primary symbol in its
    first ``t`` slots and an alias in the rest, laid out by the format's
    deterministic Vose construction (stacks popped from the end, buckets
    filled in ascending order)."""
    if table_log < 7:
        raise ValueError("MICT: alias tableLog below 7")
    M = 1 << table_log
    K = M >> 7
    freqs = _freqs(norm)
    if int(freqs.sum()) != M:
        raise ValueError("MICT: frequencies do not fill the table")
    syms = np.nonzero(freqs)[0]
    if len(syms) > 256:
        raise ValueError("MICT: alias alphabet over 256")
    w = [int(v) for v in freqs[syms]]
    small = [i for i in range(len(syms)) if w[i] < K]
    large = [i for i in range(len(syms)) if w[i] >= K]
    used = [0] * len(syms)  # slots of each symbol handed out so far
    sym = np.empty(M, np.int64)
    bias = np.empty(M, np.int64)
    for b in range(128):
        if small:
            p = small.pop()
            t = w[p]
            w[p] = 0
            if large:
                a = large[-1]
                w[a] -= K - t
                if w[a] == 0:
                    large.pop()
                elif w[a] < K:
                    small.append(large.pop())
            else:
                if not small:
                    raise ValueError("MICT: stranded alias symbol")
                ai = max(range(len(small)), key=lambda i: w[small[i]])
                a = small[ai]
                if w[a] < K - t:
                    raise ValueError("MICT: no alias covers a bucket")
                w[a] -= K - t
                if w[a] == 0:
                    small.pop(ai)
        else:
            p = a = large[-1]
            t = K
            w[p] -= K
            if w[p] == 0:
                large.pop()
            elif w[p] < K:
                small.append(large.pop())
        s0 = b * K
        sym[s0:s0 + t] = syms[p]
        bias[s0:s0 + t] = used[p] + np.arange(t)
        used[p] += t
        if t < K:
            sym[s0 + t:s0 + K] = syms[a]
            bias[s0 + t:s0 + K] = used[a] + np.arange(K - t)
            used[a] += K - t
    return sym, freqs[sym], bias


def mict_parse(blob: bytes):
    """(lanes, table_log, count, states, words, norm, alias) of a MICT
    stream; ``alias`` is None for FF 57, else (esc_val, esc_values)."""
    if len(blob) < 12 or blob[:2] not in (MICT_MAGIC, MICT_ALIAS_MAGIC):
        raise ValueError("MICT: missing magic bytes")
    is_alias = blob[:2] == MICT_ALIAS_MAGIC
    if is_alias and len(blob) < 18:
        raise ValueError("MICT: truncated alias header")
    log2_lanes, tl_hdr = struct.unpack_from("<BB", blob, 2)
    count, n_words = struct.unpack_from("<II", blob, 4)
    lanes = 1 << log2_lanes
    hdr = 12
    if is_alias:
        n_esc, esc_val = struct.unpack_from("<IH", blob, 12)
        hdr = 18
    norm, _symbol_len, table_log, consumed = read_ncount(blob[hdr:])
    if table_log != tl_hdr:
        raise ValueError("MICT: header tableLog mismatch")
    pos = hdr + consumed
    if pos + 4 * lanes + 2 * n_words > len(blob):
        raise ValueError("MICT: stream out of bounds")
    states = np.frombuffer(blob, dtype="<u4", count=lanes, offset=pos).astype(np.uint64)
    pos += 4 * lanes
    words = np.frombuffer(blob, dtype="<u2", count=n_words, offset=pos).astype(np.uint64)
    alias = None
    if is_alias:
        pos += 2 * n_words
        if pos + 2 * n_esc > len(blob):
            raise ValueError("MICT: escape stream out of bounds")
        alias = (esc_val, np.frombuffer(blob, dtype="<u2", count=n_esc, offset=pos))
    return lanes, table_log, count, states, words, norm, alias


def mict_decode(blob: bytes) -> np.ndarray:
    """The symbols of one MICT stream (u16).  Lane j of step t is symbol
    t * L + j; a lane renormalizes by one 16-bit word, the words handed
    to the lanes in lane order a step.  Raises ValueError where the final
    states, the word count or the escape count are wrong."""
    L, tl, count, x, words, norm, alias = mict_parse(blob)
    sym, freq, bias = (standard_tables if alias is None else alias_tables)(norm, tl)
    freq = freq.astype(np.uint64)
    bias = bias.astype(np.uint64)
    mask = np.uint64((1 << tl) - 1)
    n_steps = -(-count // L)
    out = np.empty(n_steps * L, dtype=np.int64)
    lane = np.arange(L)
    cursor = 0
    last = max(len(words) - 1, 0)
    for t in range(n_steps):
        active = lane < count - t * L
        slot = (x & mask).astype(np.int64)
        out[t * L:(t + 1) * L] = sym[slot]
        nx = freq[slot] * (x >> np.uint64(tl)) + bias[slot]
        need = (nx < RANS_L) & active
        at = cursor + np.cumsum(need) - need
        w = words[np.minimum(at, last)] if len(words) else np.zeros(L, np.uint64)
        nx = np.where(need, (nx << np.uint64(16)) | w, nx)
        cursor += int(need.sum())
        x = np.where(active, nx, x)
    if not np.all(x == RANS_L) or cursor != len(words):
        raise ValueError("MICT: corrupt stream (final states or word count)")
    out = out[:count]
    if alias is not None:
        esc_val, esc_values = alias
        idx = np.nonzero(out == esc_val)[0]
        if len(idx) != len(esc_values):
            raise ValueError("MICT: escape count mismatch")
        out[idx] = esc_values
    return out.astype(np.uint16)


def soa_expand(soa: np.ndarray, n_runs: int, n_same: int, mid: int) -> np.ndarray:
    """Tokens of an SoA-RLE stream: ``n_runs`` run counts (a count <=
    ``mid`` repeats the next same-value, a larger one takes count - mid
    literals), then the same-values, then the literals."""
    s = np.asarray(soa, dtype=np.int64)
    counts = s[:n_runs]
    same = counts <= mid
    lengths = np.where(same, counts, counts - mid)
    same_vals = s[n_runs:n_runs + n_same]
    lits = s[n_runs + n_same:]
    parts, si, li = [], 0, 0
    for r in range(n_runs):
        if same[r]:
            parts.append(np.full(lengths[r], same_vals[si]))
            si += 1
        else:
            parts.append(lits[li:li + lengths[r]])
            li += lengths[r]
    return np.concatenate(parts).astype(np.uint16) if parts else np.zeros(0, np.uint16)


def parse_escaped(stream: np.ndarray, delim: int, n_tokens: int):
    """(value, is_raw) a token of an escaped stream: a delimiter at an
    even offset of its run of delimiters escapes the symbol after it."""
    s = np.asarray(stream, dtype=np.uint16)
    n = s.size
    is_delim = s == delim
    starts = is_delim.copy()
    starts[1:] &= ~is_delim[:-1]
    run_id = np.cumsum(starts)
    idx = np.arange(n)
    start_pos = np.zeros(n, dtype=np.int64)
    first = idx[starts]
    if first.size:
        start_pos = np.where(is_delim, first[np.maximum(run_id - 1, 0)], 0)
    marker = is_delim & ((idx - start_pos) % 2 == 0)
    consumed = np.zeros(n, dtype=bool)
    consumed[1:] = marker[:-1]
    tok = idx[~consumed]
    if tok.size < n_tokens:
        raise ValueError("escaped stream truncated")
    tok = tok[:n_tokens]
    is_raw = marker[tok]
    values = np.where(is_raw, s[np.minimum(tok + 1, n - 1)], s[tok])
    return values.astype(np.uint16), is_raw


def unzigzag(u: np.ndarray) -> np.ndarray:
    """u16 ZigZag symbols -> int64 differences in [-32768, 32767]."""
    u = np.asarray(u).astype(np.int64)
    return (u >> 1) ^ -(u & 1)


def predictor_decode(values, is_raw, width: int, height: int, max_value: int, kind: str):
    """Pixels from escaped residual tokens.  ``zz``: each row a running
    sum of ZigZag differences.  ``avg``: pixel = ((W + N) >> 1) + value -
    threshold (W on the first row, N on the first column), by wavefronts
    k = 2i + j, whose neighbours lie on earlier wavefronts.  A raw token
    is the pixel itself."""
    thr = delta_params(max_value)[0]
    vals = values.astype(np.int64).reshape(height, width)
    raw = np.asarray(is_raw, dtype=bool).reshape(height, width)
    out = np.zeros((height, width), dtype=np.int64)
    if kind == "zz":
        dz = unzigzag(values).reshape(height, width)
        col = np.where(raw[:, 0], vals[:, 0], dz[:, 0]) & 0xFFFF
        out[:, 0] = col
        for x in range(1, width):
            col = np.where(raw[:, x], vals[:, x], col + dz[:, x]) & 0xFFFF
            out[:, x] = col
        return out.astype(np.uint16)
    flat, v, r, d = out.ravel(), vals.ravel(), raw.ravel(), (vals - thr).ravel()
    flat[0] = v[0] if r[0] else d[0] & 0xFFFF
    for k in range(1, 2 * (height - 1) + width):
        ii = np.arange(max(0, (k - width + 2) // 2), min(height - 1, k // 2) + 1)
        jj = k - 2 * ii
        keep = (jj >= 0) & (jj < width) & ~((ii == 0) & (jj == 0))
        ii, jj = ii[keep], jj[keep]
        if not ii.size:
            continue
        pos = ii * width + jj
        w_v = np.where(jj > 0, flat[pos - 1], 0)
        n_v = np.where(ii > 0, flat[pos - width], 0)
        pred = np.where(ii == 0, w_v, np.where(jj == 0, n_v, (w_v + n_v) >> 1))
        flat[pos] = np.where(r[pos], v[pos], (pred + d[pos]) & 0xFFFF)
    return out.astype(np.uint16)


def _direct_inverse(syms: np.ndarray, width: int, rows: int, pred: str) -> np.ndarray:
    """Pixels of a direct strip: ZigZag differences summed mod 2^16 along
    rows (zzd), columns (vdd) or both (pdd)."""
    d = unzigzag(syms).reshape(rows, width)
    if pred == "pdd":
        return (np.cumsum(np.cumsum(d, axis=1) & 0xFFFF, axis=0) & 0xFFFF).astype(np.uint16)
    return (np.cumsum(d, axis=1 if pred == "zzd" else 0) & 0xFFFF).astype(np.uint16)


def micw_parse(blob: bytes):
    """(width, height, strip_h, max_value, global predictor, band, strips)
    of a MICW container; ``band`` is (orig_width, orig_height) of a banded
    one, else None; strips are (mict bytes, n_soa, n_tok, n_runs, n_same,
    mode)."""
    if len(blob) < MICW_HEADER or blob[:4] != MICW_MAGIC:
        raise ValueError("micw: invalid magic")
    width, height, num_strips, strip_h = struct.unpack_from("<IIII", blob, 4)
    max_value, flags, _lanes_log2 = struct.unpack_from("<HBB", blob, 20)
    hdr, band = MICW_HEADER, None
    if flags & FLAG_BANDED:
        band = struct.unpack_from("<II", blob, hdr)
        hdr += 8
    if len(blob) < hdr + num_strips * MICW_ENTRY:
        raise ValueError("micw: truncated strip table")
    data0 = hdr + num_strips * MICW_ENTRY
    strips = []
    for s in range(num_strips):
        off, ln, *rest = struct.unpack_from("<IIIIIII", blob, hdr + s * MICW_ENTRY)
        if data0 + off + ln > len(blob):
            raise ValueError("micw: strip data out of bounds")
        strips.append((blob[data0 + off:data0 + off + ln], *rest))
    gpred = "zzd" if flags & FLAG_DIRECT else ("avg" if flags & FLAG_AVG_PREDICTOR else "zz")
    return width, height, strip_h, max_value, gpred, band, strips


def decode_micw(blob: bytes) -> tuple[np.ndarray, int, int]:
    """(pixels u16 in image order, width, height) of a MICW container."""
    width, height, strip_h, max_value, gpred, band, strips = micw_parse(blob)
    out = np.empty(width * height, dtype=np.uint16)
    for i, (b, _n_soa, n_tok, n_runs, n_same, mode) in enumerate(strips):
        y0 = i * strip_h
        rows = min(strip_h, height - y0)
        n = width * rows
        seg = out[y0 * width:y0 * width + n]
        if mode == MODE_CONST:
            seg[:] = np.frombuffer(b, dtype="<u2", count=1)[0]
            continue
        if mode == MODE_RAW:
            seg[:] = np.frombuffer(b, dtype="<u2", count=n)
            continue
        pred = gpred if mode == MODE_MICT else MODE_PRED[mode]
        if pred in ("zzd", "vdd", "pdd"):
            seg[:] = _direct_inverse(mict_decode(b)[:n], width, rows, pred).ravel()
        elif pred in ("zzr", "vdr", "pdr"):
            syms = soa_expand(mict_decode(b), n_runs, n_same, MID_DIRECT)
            if len(syms) != n_tok:
                raise ValueError("micw: r-mode token count mismatch")
            seg[:] = _direct_inverse(syms[:n], width, rows, pred[:2] + "d").ravel()
        else:
            tokens = soa_expand(mict_decode(b), n_runs, n_same, rle_mid(max_value))
            if len(tokens) != n_tok:
                raise ValueError("micw: token count mismatch")
            values, is_raw = parse_escaped(tokens[1:], delta_params(max_value)[1], n)
            seg[:] = predictor_decode(values, is_raw, width, rows, int(tokens[0]),
                                      pred).ravel()
    if band is None:
        return out, width, height
    ow, oh = band
    img = out.reshape(ow // width, oh, width).transpose(1, 0, 2)
    return np.ascontiguousarray(img).reshape(-1), ow, oh
