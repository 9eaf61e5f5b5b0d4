"""FSE core for 16-bit alphabets: histogram, tableLog selection, count
normalization and the normalized-count header.

A numpy copy of the parts of ``mic_tpu.ops.fse`` the port needs (the
MICT stream header of both entropy families is this header, the
reference formats' tANS streams decode through ``build_dtable`` and
``dryrun.py`` encodes them through ``build_ctable``), with
the same names and the same bytes; pinned to the original, to
``mic_tpu.native``'s C++ pair where it is built, and to the port's own
C++ pair (``mic_tpu_torch.native``, which MICT's host staging calls) by
``tests/test_torch_isolation.py``, ``tests/test_torch_tans_decode.py``
and ``tests/test_torch_native.py``.
Reference files: fseu16.go, fsecompressu16.go, fsedecompressu16.go.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "MAX_TABLE_LOG",
    "DEFAULT_TABLE_LOG",
    "MIN_TABLE_LOG",
    "MAX_SYMBOL_VALUE",
    "IncompressibleError",
    "UseRLEError",
    "histogram",
    "optimal_table_log",
    "normalize_count",
    "write_count",
    "read_ncount",
    "build_ctable",
    "build_dtable",
]

# Reference: fseu16.go:15-29.  maxMemoryUsage=18 => maxTableLog=16.
MAX_TABLE_LOG = 16
DEFAULT_TABLE_LOG = 11
MIN_TABLE_LOG = 5
MAX_SYMBOL_VALUE = 65535
TABLELOG_ABSOLUTE_MAX = 17  # fsedecompressu16.go:15


class IncompressibleError(Exception):
    """Input judged too hard to compress (reference ErrIncompressible)."""


class UseRLEError(Exception):
    """Input is a single repeated value (reference ErrUseRLE)."""


def histogram(data: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Histogram of a uint16 stream: ``(counts, max_count, symbol_len)``
    with ``symbol_len`` the highest present symbol + 1."""
    data = np.asarray(data, dtype=np.uint16)
    counts = np.bincount(data, minlength=1).astype(np.uint32)
    symbol_len = int(counts.size)  # bincount trims trailing zeros beyond max
    max_count = int(counts.max()) if counts.size else 0
    return counts, max_count, symbol_len


def _high_bits(val: int) -> int:
    return val.bit_length() - 1


def optimal_table_log(table_log: int, src_len: int, symbol_len: int) -> int:
    """Adaptive tableLog selection (fsecompressu16.go:465-518), with the
    density adaptation that lifts tableLog to 12/13 for dense large
    alphabets."""
    min_bits_src = _high_bits(src_len - 1) + 1
    min_bits_symbols = _high_bits(symbol_len - 1) + 2
    min_bits = min(min_bits_src, min_bits_symbols)
    max_bits_src = _high_bits(src_len - 1) - 2

    if max_bits_src < table_log:
        table_log = max_bits_src
    if min_bits > table_log:
        table_log = min_bits

    symbol_density = src_len // symbol_len
    if symbol_len > 512 and symbol_density > 16 and table_log < 13:
        table_log = 13
    elif symbol_density > 64 and symbol_len > 256 and table_log < 12:
        table_log = 12
    elif symbol_density > 32 and symbol_len > 128 and table_log < 12:
        table_log = 12

    if max_bits_src < table_log:
        table_log = max_bits_src
    if table_log < MIN_TABLE_LOG:
        table_log = MIN_TABLE_LOG
    if table_log > MAX_TABLE_LOG:
        table_log = MAX_TABLE_LOG
    return table_log


# Reference: fsecompressu16.go:520.
_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)

_U64 = (1 << 64) - 1


def normalize_count(
    counts: np.ndarray, total: int, table_log: int, symbol_len: int
) -> np.ndarray:
    """Normalize counts so they sum to ``1 << table_log`` (primary method,
    fsecompressu16.go:524-571, with the normalizeCount2 fallback).
    ``-1`` marks low-probability symbols."""
    counts = np.asarray(counts[:symbol_len], dtype=np.int64)
    norm = np.zeros(symbol_len, dtype=np.int64)

    scale = 62 - table_log
    step = (1 << 62) // total  # uint64 semantics; total < 2^31 so no wrap
    v_step = 1 << (scale - 20)
    still_to_distribute = 1 << table_log
    low_threshold = total >> table_log

    largest = 0
    largest_p = 0
    for i in range(symbol_len):
        cnt = int(counts[i])
        if cnt == 0:
            continue
        if cnt <= low_threshold:
            norm[i] = -1
            still_to_distribute -= 1
        else:
            proba = ((cnt * step) & _U64) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                v = ((cnt * step) & _U64) - ((proba << scale) & _U64)
                v &= _U64
                if v > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = i
            norm[i] = proba
            still_to_distribute -= proba

    if -still_to_distribute >= (int(norm[largest]) >> 1):
        return _normalize_count2(counts, total, table_log, symbol_len)
    norm[largest] += still_to_distribute
    return norm


def _normalize_count2(
    counts: np.ndarray, total_in: int, table_log: int, symbol_len: int
) -> np.ndarray:
    """normalizeCount2 (fsecompressu16.go:575-667)."""
    NOT_YET_ASSIGNED = -2
    norm = np.zeros(symbol_len, dtype=np.int64)
    distributed = 0
    total = total_in
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)

    for i in range(symbol_len):
        cnt = int(counts[i])
        if cnt == 0:
            norm[i] = 0
            continue
        if cnt <= low_threshold:
            norm[i] = -1
            distributed += 1
            total -= cnt
            continue
        if cnt <= low_one:
            norm[i] = 1
            distributed += 1
            total -= cnt
            continue
        norm[i] = NOT_YET_ASSIGNED

    to_distribute = (1 << table_log) - distributed

    if to_distribute > 0 and (total // to_distribute) > low_one:
        low_one = (total * 3) // (to_distribute * 2)
        for i in range(symbol_len):
            if norm[i] == NOT_YET_ASSIGNED and int(counts[i]) <= low_one:
                norm[i] = 1
                distributed += 1
                total -= int(counts[i])
        to_distribute = (1 << table_log) - distributed

    if distributed == symbol_len + 1:
        # All values poor: give everything to the max symbol.
        max_v = int(np.argmax(counts))
        norm[max_v] += to_distribute
        return norm

    if total == 0:
        i = 0
        while to_distribute > 0:
            if norm[i] > 0:
                to_distribute -= 1
                norm[i] += 1
            i = (i + 1) % symbol_len
        return norm

    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = (((1 << v_step_log) * to_distribute) + mid) // total
    tmp_total = mid
    for i in range(symbol_len):
        if norm[i] == NOT_YET_ASSIGNED:
            end = tmp_total + int(counts[i]) * r_step
            s_start = tmp_total >> v_step_log
            s_end = end >> v_step_log
            weight = s_end - s_start
            if weight < 1:
                raise ValueError("normalizeCount2: weight < 1")
            norm[i] = weight
            tmp_total = end
    return norm


def write_count(norm: np.ndarray, symbol_len: int, table_log: int) -> bytes:
    """Serialize the normalized histogram (fsecompressu16.go:191-289):
    24-symbol zero bursts cost 16 bits, 3-symbol bursts 2 bits, then a
    2-bit remainder; counts take ``tableLog+1`` bits, shrinking as the
    remaining probability mass halves."""
    table_size = 1 << table_log
    out = bytearray()
    bit_stream = table_log - MIN_TABLE_LOG
    bit_count = 4
    remaining = table_size + 1  # +1 for extra accuracy
    threshold = table_size
    nb_bits = table_log + 1
    previous0 = False
    charnum = 0

    norm = np.asarray(norm, dtype=np.int64)

    while remaining > 1:
        if previous0:
            start = charnum
            while norm[charnum] == 0:
                charnum += 1
            while charnum >= start + 24:
                start += 24
                bit_stream += 0xFFFF << bit_count
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
            while charnum >= start + 3:
                start += 3
                bit_stream += 3 << bit_count
                bit_count += 2
            bit_stream += (charnum - start) << bit_count
            bit_count += 2
            if bit_count > 16:
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
                bit_count -= 16

        count = int(norm[charnum])
        charnum += 1
        maxv = (2 * threshold - 1) - remaining
        if count < 0:
            remaining += count
        else:
            remaining -= count
        count += 1  # +1 for extra accuracy
        if count >= threshold:
            count += maxv
        bit_stream += count << bit_count
        bit_count += nb_bits
        if count < maxv:
            bit_count -= 1

        previous0 = count == 1
        if remaining < 1:
            raise ValueError("writeCount: internal error remaining < 1")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

        if bit_count > 16:
            out.append(bit_stream & 0xFF)
            out.append((bit_stream >> 8) & 0xFF)
            bit_stream >>= 16
            bit_count -= 16

    out.append(bit_stream & 0xFF)
    out.append((bit_stream >> 8) & 0xFF)
    # Only (bit_count+7)//8 of those last two bytes are real.
    extra = (bit_count + 7) // 8
    out = out[: len(out) - 2 + extra]

    if charnum > symbol_len:
        raise ValueError("writeCount: charnum > symbol_len")
    return bytes(out)


def read_ncount(data: bytes) -> tuple[np.ndarray, int, int, int]:
    """Parse a normalized-count header (fsedecompressu16.go:48-167).
    Returns ``(norm, symbol_len, table_log, bytes_consumed)``."""
    iend = len(data)
    if iend < 4:
        raise ValueError("input too small")
    buf = data

    def u32(off: int) -> int:
        return int.from_bytes(buf[off : off + 4], "little")

    off = 0
    bit_stream = u32(off)
    nb_bits = (bit_stream & 0xF) + MIN_TABLE_LOG
    if nb_bits > TABLELOG_ABSOLUTE_MAX:
        raise ValueError("tableLog too large")
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
                raise ValueError("maxSymbolValue too small")
            while charnum < n0:
                norm[charnum & 0xFFFF] = 0
                charnum += 1
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

        count -= 1  # extra accuracy
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

    symbol_len = charnum
    if symbol_len <= 1:
        raise ValueError(f"symbolLen ({symbol_len}) too small")
    if symbol_len > MAX_SYMBOL_VALUE + 1:
        raise ValueError(f"symbolLen ({symbol_len}) too big")
    if remaining != 1:
        raise ValueError(f"corruption detected (remaining {remaining} != 1)")
    if bit_count > 32:
        raise ValueError(f"corruption detected (bitCount {bit_count} > 32)")
    if got_total != (1 << table_log):
        raise ValueError(
            f"corruption detected (total {got_total} != {1 << table_log})"
        )
    off += (bit_count + 7) >> 3
    return norm[:symbol_len].copy(), symbol_len, table_log, off


def _table_step(table_size: int) -> int:
    # Reference: fseu16.go:166-168.
    return (table_size >> 1) + (table_size >> 3) + 3


def _spread_symbols(norm: np.ndarray, symbol_len: int, table_log: int) -> np.ndarray:
    """Spread symbols over the state table: low-probability (-1) symbols
    occupy the top of the table; the rest are scattered by the co-prime
    step walk skipping the low-prob region (fsedecompressu16.go:221-240).
    The walk visits k * step mod size for k = 0, 1, ... (step is odd, so
    every position once a cycle), skipping the top: the positions are
    that progression filtered, and symbol i of the spread takes the i-th
    of them, cycle after cycle, the last write holding."""
    table_size = 1 << table_log
    table_symbol = np.zeros(table_size, dtype=np.uint16)
    norm = np.asarray(norm[:symbol_len], dtype=np.int64)
    present = np.flatnonzero(norm)  # a 16-bit alphabet holds a few hundred symbols
    counts = norm[present]
    low = present[counts == -1]
    table_symbol[table_size - 1 - np.arange(low.size)] = low
    high_threshold = table_size - 1 - low.size
    syms = np.repeat(present[counts > 0], counts[counts > 0])
    walk = (np.arange(table_size) * _table_step(table_size)) & (table_size - 1)
    walk = walk[walk <= high_threshold]
    if syms.size and (walk.size == 0 or syms.size % walk.size):
        raise ValueError("corrupted input (position != 0)")
    if syms.size:
        keep = syms[-walk.size:]  # a spread past one cycle: its last cycle holds
        table_symbol[walk[np.arange(syms.size - keep.size, syms.size) % walk.size]] = keep
    return table_symbol


def build_ctable(
    norm: np.ndarray, symbol_len: int, table_log: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Build the compression tables (fsecompressu16.go:329-431).

    Returns ``(state_table u32[ts], delta_nb_bits u32[symbol_len],
    delta_find_state i64[symbol_len], zero_bits)``.  Encode step for
    symbol s from state x (fsecompressu16.go:95-100): ``nb = (x +
    delta_nb_bits[s]) >> 16``, emit the low nb bits of x, then ``x' =
    state_table[(x >> nb) + delta_find_state[s]]``.
    """
    table_size = 1 << table_log
    norm = np.asarray(norm, dtype=np.int64)
    sizes = np.where(norm == -1, 1, np.maximum(norm, 0))  # low-prob symbols take 1 slot
    if int(sizes[:symbol_len].sum()) != table_size:
        raise ValueError("buildCTable: cumul mismatch")
    table_symbol = _spread_symbols(norm, symbol_len, table_log)
    # For table position u holding symbol v: state_table[cumul[v]++] = ts +
    # u; a stable argsort of the spread groups positions by symbol in that
    # order.
    order = np.argsort(table_symbol, kind="stable")
    state_table = (table_size + order).astype(np.uint32)
    zero_bits = bool(np.any(norm > (1 << (table_log - 1))))
    delta_nb_bits = np.zeros(symbol_len, dtype=np.uint32)
    delta_find_state = np.zeros(symbol_len, dtype=np.int64)
    total = 0
    tl = ((table_log << 16) - (1 << table_log)) & 0xFFFFFFFF
    for i in range(symbol_len):
        v = int(norm[i])
        if v == 0:
            continue
        if v == -1 or v == 1:
            delta_nb_bits[i] = tl
            delta_find_state[i] = total - 1
            total += 1
        else:
            max_bits_out = table_log - _high_bits(v - 1)
            min_state_plus = v << max_bits_out
            delta_nb_bits[i] = ((max_bits_out << 16) - min_state_plus) & 0xFFFFFFFF
            delta_find_state[i] = total - v
            total += v
    if total != table_size:
        raise ValueError(f"buildCTable: total {total} != {table_size}")
    return state_table, delta_nb_bits, delta_find_state, zero_bits


def build_dtable(
    norm: np.ndarray, symbol_len: int, table_log: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Build the decode table (fsedecompressu16.go:198-263).

    Returns ``(new_state u32[ts], symbol u16[ts], nb_bits u8[ts], zero_bits)``.
    Decode step from state x: emit ``symbol[x]``; then
    ``x' = new_state[x] + read_bits(nb_bits[x])``.
    """
    table_size = 1 << table_log
    norm = np.asarray(norm, dtype=np.int64)
    table_symbol = _spread_symbols(norm, symbol_len, table_log)

    zero_bits = bool(np.any(norm >= (1 << (table_log - 1))))  # -1 never reaches it

    # Each slot's occurrence rank within its symbol group, in table order:
    # symbol_next[s] starts at norm[s] (1 for low-prob) and counts up.  The
    # arithmetic runs over the symbols with a count (and symbol 0, which a
    # slot the spread left empty holds): k maps each slot's symbol to them.
    has = norm != 0
    has[:1] = True
    present = np.flatnonzero(has)
    start = np.where(norm[present] == -1, 1, np.maximum(norm[present], 0))
    k = np.searchsorted(present, table_symbol)
    order = np.argsort(table_symbol, kind="stable")
    first_slot = np.cumsum(start) - start
    ranks = np.empty(table_size, dtype=np.int64)
    ranks[order] = np.arange(table_size) - first_slot[k[order]]

    next_state = start[k] + ranks
    hb = np.frexp(next_state)[1].astype(np.int64) - 1  # exact floor(log2): next_state >= 1
    nb = table_log - hb
    new_state = ((next_state << nb) - table_size).astype(np.int64)
    if np.any((new_state < 0) | (new_state >= table_size)):
        raise ValueError("buildDtable: newState outside table")
    bad = (new_state == np.arange(table_size)) & (nb == 0)
    if np.any(bad):
        raise ValueError("buildDtable: newState == oldState with no bits")
    return (
        new_state.astype(np.uint32),
        table_symbol.astype(np.uint16),
        nb.astype(np.uint8),
        zero_bits,
    )
