"""8-state interleaved rANS of the reference format (magic FF 08).

A numpy copy of ``build_rans_dec_table``, ``rans_decompress_8state``,
``build_rans_enc_table`` and ``rans_compress_8state`` of
``mic_tpu.ops.rans`` (same names, same outputs; the decode side pinned by
``tests/test_torch_tans_decode.py``, the encode side by
``tests/test_torch_mesh.py``; ``dryrun.py`` encodes its FF 08 streams
with it).  Stream format:
``[0xFF][0x08][count u32 LE][writeCount header][bitstream]``
(rans8state.go:14-17,27).  The decode step has the shape of the tANS
step, ``x' = newState[x] + readBits(nbBits[x])`` (ransu16.go:33-39); only
the table differs (linear slot fill instead of the co-prime spread,
ransu16.go:77-135), so the device decode shares the tANS kernel.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriterLSB, ReverseBitReader
from .fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    histogram,
    normalize_count,
    optimal_table_log,
    read_ncount,
    write_count,
)

__all__ = ["build_rans_dec_table", "rans_decompress_8state", "build_rans_enc_table",
           "rans_compress_8state"]

MAGIC_8STATE_RANS = b"\xff\x08"
DECOMPRESS_LIMIT_DEFAULT = (2 << 30) - 1


def _high_bits_arr(v: np.ndarray) -> np.ndarray:
    hb = np.zeros(v.shape, dtype=np.int64)
    x = v.astype(np.int64).copy()
    for shift in (16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        hb[m] += shift
        x[m] >>= shift
    return hb


def build_rans_dec_table(
    norm: np.ndarray, symbol_len: int, table_log: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linear-fill rANS decode table (ransu16.go:77-135).

    Slots are assigned sequentially: all norm>0 symbols in symbol order,
    then all low-probability (norm == -1) symbols as freq-1 entries.
    Returns ``(new_state u32[ts], symbol u16[ts], nb_bits u8[ts])``.
    """
    table_size = 1 << table_log
    norm = np.asarray(norm, dtype=np.int64)

    pos_syms = np.nonzero(norm > 0)[0]
    freqs = norm[pos_syms]
    # x_next per slot within a symbol run: freq + j for j in [0, freq)
    symbol = np.repeat(pos_syms, freqs)
    offs = np.arange(int(freqs.sum()), dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(freqs)))[:-1], freqs
    )
    x_next = np.repeat(freqs, freqs) + offs

    low_syms = np.nonzero(norm == -1)[0]
    if low_syms.size:
        symbol = np.concatenate([symbol, low_syms])
        x_next = np.concatenate([x_next, np.ones(low_syms.size, dtype=np.int64)])

    if symbol.size != table_size:
        raise ValueError(
            f"ransDecTable: filled {symbol.size} of {table_size} slots"
        )

    nb = table_log - _high_bits_arr(x_next)
    new_state = (x_next << nb) - table_size
    if np.any((new_state < 0) | (new_state >= table_size)):
        raise ValueError("ransDecTable: newStateBase out of range")
    return (
        new_state.astype(np.uint32),
        symbol.astype(np.uint16),
        nb.astype(np.uint8),
    )


def rans_decompress_8state(
    data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT
) -> np.ndarray:
    """8-lane interleaved rANS decompress (reference
    RANSDecompressU16EightState)."""
    if len(data) < 6 or data[:2] != MAGIC_8STATE_RANS:
        raise ValueError("rans8state: missing magic bytes")
    count = int.from_bytes(data[2:6], "little")
    if count > limit:
        raise ValueError(f"declared count ({count}) > DecompressLimit ({limit})")
    body = data[6:]
    norm, symbol_len, table_log, consumed = read_ncount(body)
    new_state, symbol, nb_bits = build_rans_dec_table(norm, symbol_len, table_log)

    r = ReverseBitReader(body[consumed:])
    ns = new_state.tolist()
    sym = symbol.tolist()
    nb = nb_bits.tolist()
    get = r.get_bits
    states = [get(table_log) for _ in range(8)]
    out = [0] * count
    for i in range(count):
        lane = i & 7
        x = states[lane]
        out[i] = sym[x]
        states[lane] = ns[x] + get(nb[x])
    return np.array(out, dtype=np.uint16)


def build_rans_enc_table(
    norm: np.ndarray, symbol_len: int, table_log: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-symbol rANS encode parameters (ransu16.go:139-180): ``(freq,
    bias, k0, threshold)`` indexed by symbol, in the decode table's
    cumulative order (norm > 0 symbols, then low-probability ones)."""
    norm = np.asarray(norm, dtype=np.int64)
    freq = np.zeros(symbol_len, dtype=np.int64)
    bias = np.zeros(symbol_len, dtype=np.int64)
    k0 = np.zeros(symbol_len, dtype=np.int64)
    cumul = 0
    for sym in range(symbol_len):
        v = int(norm[sym])
        if v <= 0:
            continue
        freq[sym] = v
        bias[sym] = cumul
        k0[sym] = table_log - _high_bits_arr(np.array([v]))[0]
        cumul += v
    for sym in range(symbol_len):
        if norm[sym] != -1:
            continue
        freq[sym] = 1
        bias[sym] = cumul
        k0[sym] = table_log
        cumul += 1
    if cumul != (1 << table_log):
        raise ValueError(f"buildRansEncTable: cumul {cumul} != {1 << table_log}")
    return freq, bias, k0, freq << k0


def rans_compress_8state(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """8-lane interleaved rANS compress (reference
    RANSCompressU16EightState): ``MAGIC_8STATE_RANS``, the count, the
    header and the bitstream."""
    data = np.asarray(data, dtype=np.uint16)
    n = len(data)
    if n <= 7:
        raise IncompressibleError
    counts, max_count, symbol_len = histogram(data)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    actual_tl = optimal_table_log(table_log, n, symbol_len)
    norm = normalize_count(counts, n, actual_tl, symbol_len)
    if int(np.abs(norm).sum()) != (1 << actual_tl):  # reference validateNorm
        raise IncompressibleError
    header = write_count(norm, symbol_len, actual_tl)
    freq, bias, k0, thr = (a.tolist() for a in build_rans_enc_table(norm, symbol_len,
                                                                     actual_tl))
    table_size = 1 << actual_tl
    src = data.tolist()
    states = [0] * 8
    w = BitWriterLSB()
    vap, wap = w.values.append, w.widths.append
    for i in range(n - 1, -1, -1):
        s = src[i]
        lane = i & 7
        x_l = states[lane] + table_size
        k = k0[s]
        if x_l < thr[s]:
            k -= 1
        vap(x_l)
        wap(k)
        states[lane] = bias[s] + (x_l >> k) - freq[s]
    for lane in range(7, -1, -1):
        vap(states[lane])
        wap(actual_tl)
    out = header + w.close()
    if len(out) >= n * 2:
        raise IncompressibleError
    return MAGIC_8STATE_RANS + int(n).to_bytes(4, "little") + out
