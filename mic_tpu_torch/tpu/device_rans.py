"""Host side of the wide-lane rANS device format (MICT, FF 57 / FF 41).

A jax-free copy of the parts of ``mic_tpu.tpu.device_rans`` the port's
kernels need.  Decode: the stream parser and the slot / alias table
builders the decode kernels' operands are made from.  Encode: the
normalization + ncount header (``_norm_and_header``) and the alias
escape-fold plan (``_alias_plan`` / ``_alias_apply`` /
``alias_encode_plan``) that define an encoded blob's bytes; the rANS
scan itself is the encode kernel's (``rans_encode``).  The ncount header
is read and written by the port's numpy copies in ``..ops.fse``.  The
copies here are pinned to the originals by
``tests/test_torch_host_format.py`` and ``tests/test_torch_rans_encode.py``.

Stream layout (magic 0xFF 0x57 'W'; FF 41 adds the escape fields)::

    FF 57 | log2_lanes u8 | table_log u8 | count u32 | n_words u32
    [FF 41 only: n_esc u32 | esc_val u16]
    normalized-count header (write_count)
    initial states: L x u32 LE
    renorm words:  n_words x u16 LE  (decoder order)
    [FF 41 only: escape side stream, n_esc x u16 LE]
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.fse import (
    IncompressibleError,
    normalize_count,
    optimal_table_log,
    read_ncount,
    write_count,
)

__all__ = [
    "MICT_MAGIC",
    "MICT_ALIAS_MAGIC",
    "RANS_L",
    "ALIAS_MAX_KEPT",
    "AliasInfeasible",
    "encode_tables",
    "device_tables",
    "alias_construct",
    "alias_slot_tables",
    "slot_tables",
    "mict_parse",
    "alias_encode_plan",
]

MICT_MAGIC = b"\xffW"
MICT_ALIAS_MAGIC = b"\xffA"  # alias-mapped slot permutation (see alias_construct)
RANS_L = 1 << 16  # state lower bound / renorm threshold
ALIAS_MAX_KEPT = 255  # kept symbols per alias stream (alphabet incl. ESC <= 256)


class AliasInfeasible(ValueError):
    """No 128-bucket/2-symbol alias layout exists for this normalized
    distribution (alphabet > 256, or pairing strands a symbol)."""


def _freqs_from_norm(norm: np.ndarray) -> np.ndarray:
    """Device frequencies: low-probability (-1) symbols get freq 1; plain
    symbol-order cumulation (the device format's own convention)."""
    return np.where(norm == -1, 1, np.maximum(norm, 0)).astype(np.int32)


def encode_tables(norm: np.ndarray, table_log: int):
    """(freq_sym, cumul_sym) of a normalized distribution."""
    freqs = _freqs_from_norm(norm)
    if int(freqs.sum()) != (1 << table_log):
        raise ValueError("encode_tables: freqs do not sum to table size")
    cumul = np.concatenate(([0], np.cumsum(freqs)))[:-1].astype(np.int32)
    return freqs, cumul


def device_tables(norm: np.ndarray, table_log: int):
    """Slot-indexed decode tables of a standard (FF 57) stream.

    Decode step (per lane):  slot = x & mask
        x' = freq[slot] * (x >> tl) + bias[slot]       (bias = slot-local)
        if x' < 2^16:  x' = (x' << 16) | next_word

    Returns (sym[2^tl] u16, freq_slot[2^tl] u32, bias_slot[2^tl] u32,
             freq_sym, cumul_sym).
    """
    freqs, cumul = encode_tables(norm, table_log)
    table_size = 1 << table_log
    present = np.nonzero(freqs)[0]
    sym = np.repeat(present, freqs[present]).astype(np.uint16)
    slot = np.arange(table_size, dtype=np.int64)
    freq_slot = freqs[sym].astype(np.uint32)
    bias_slot = (slot - cumul[sym]).astype(np.uint32)
    return sym, freq_slot, bias_slot, freqs, cumul


def alias_construct(norm: np.ndarray, table_log: int):
    """Deterministic integer Vose alias layout over exactly 128 buckets.

    The 2^tl decode slots are regrouped into 128 equal buckets of
    K = 2^(tl-7) slots, each holding at most two symbols: a primary in
    the first ``t`` slots and an alias in the rest.  Encoder and decoder
    both derive the layout from the normalized counts with this routine
    (stacks popped from the end, buckets filled in ascending order), so
    nothing extra rides the stream header.

    Returns a dict with per-bucket arrays (length 128) ``p``/``a``
    (symbols), ``t`` (primary slot count), ``fp``/``fa`` (frequencies),
    ``sbp``/``sba`` (per-symbol slot index of each bucket's first
    primary/alias slot), plus ``slot_of`` and ``enc_runs`` (the
    encoder's permutation, kept so the dict matches the original).
    """
    if table_log < 7:
        raise ValueError("alias_construct: table_log must be >= 7")
    M = 1 << table_log
    K = M >> 7
    freqs = _freqs_from_norm(norm)
    if int(freqs.sum()) != M:
        raise ValueError("alias_construct: freqs do not sum to table size")
    syms = np.nonzero(freqs)[0]
    if len(syms) > 256:
        raise AliasInfeasible(f"alphabet {len(syms)} > 256")
    w = [int(v) for v in freqs[syms]]
    cumul = np.zeros(len(syms) + 1, np.int64)
    np.cumsum(freqs[syms], out=cumul[1:])
    cm = [int(v) for v in cumul[:-1]]
    small = [i for i in range(len(syms)) if w[i] < K]
    large = [i for i in range(len(syms)) if w[i] >= K]
    p_arr = np.zeros(128, np.int64)
    a_arr = np.zeros(128, np.int64)
    t_arr = np.zeros(128, np.int64)
    sbp = np.zeros(128, np.int64)
    sba = np.zeros(128, np.int64)
    counter = [0] * len(syms)
    run_src = []  # (standard-layout start, alias-slot start, length)
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
                # Larges exhausted: pair two smalls (alias = max-weight
                # small, lowest index on ties) or give up.
                if not small:
                    raise AliasInfeasible("stranded small symbol")
                ai = max(range(len(small)), key=lambda i: w[small[i]])
                a = small[ai]
                if w[a] < K - t:
                    raise AliasInfeasible("no alias covers the bucket")
                w[a] -= K - t
                if w[a] == 0:
                    small.pop(ai)
        else:
            p = large[-1]
            t = K
            a = p
            w[p] -= K
            if w[p] == 0:
                large.pop()
            elif w[p] < K:
                small.append(large.pop())
        p_arr[b], a_arr[b], t_arr[b] = p, a, t
        sbp[b] = counter[p]
        run_src.append((cm[p] + counter[p], b * K, t))
        counter[p] += t
        if t < K:
            sba[b] = counter[a]
            run_src.append((cm[a] + counter[a], b * K + t, K - t))
            counter[a] += K - t
        else:
            sba[b] = counter[a] if a != p else 0
    starts = np.array([r[0] for r in run_src], np.int64)
    dsts = np.array([r[1] for r in run_src], np.int64)
    lens = np.array([r[2] for r in run_src], np.int64)
    order = np.argsort(starts, kind="stable")
    starts, dsts, lens = starts[order], dsts[order], lens[order]
    delta = np.repeat(dsts - starts, lens)
    slot_of = (np.arange(M, dtype=np.int64) + delta).astype(np.uint32)
    enc_runs = (starts.astype(np.uint32), dsts.astype(np.uint32))
    f = freqs[syms]
    return {
        "syms": syms,
        "cumul": cumul,
        "p": syms[p_arr].astype(np.uint32),
        "a": syms[a_arr].astype(np.uint32),
        "t": t_arr.astype(np.uint32),
        "fp": f[p_arr].astype(np.uint32),
        "fa": f[a_arr].astype(np.uint32),
        "sbp": sbp.astype(np.uint32),
        "sba": sba.astype(np.uint32),
        "slot_of": slot_of,
        "enc_runs": enc_runs,
    }


def alias_slot_tables(norm: np.ndarray, table_log: int):
    """Slot-indexed (sym, freq, bias) decode tables of an alias-mapped
    stream, in the layout device_tables returns for standard streams."""
    al = alias_construct(norm, table_log)
    M = 1 << table_log
    K = M >> 7
    off = np.tile(np.arange(K, dtype=np.int64), 128)
    bkt = np.repeat(np.arange(128, dtype=np.int64), K)
    is_p = off < al["t"][bkt]
    sym = np.where(is_p, al["p"][bkt], al["a"][bkt]).astype(np.uint16)
    freq_slot = np.where(is_p, al["fp"][bkt], al["fa"][bkt]).astype(np.uint32)
    bias_slot = np.where(
        is_p, al["sbp"][bkt] + off, al["sba"][bkt] + off - al["t"][bkt]
    ).astype(np.uint32)
    freqs, cumul = encode_tables(norm, table_log)
    return sym, freq_slot, bias_slot, freqs, cumul


def slot_tables(norm: np.ndarray, table_log: int, alias: bool):
    """Dispatch to the standard or alias slot-table builder."""
    return (alias_slot_tables if alias else device_tables)(norm, table_log)


def mict_parse(blob: bytes):
    """Parse a MICT blob.  Returns (lanes, table_log, count,
    init_states u32[L], words u16[W], norm, symbol_len, alias) — alias
    is None for standard streams, or (esc_val, esc_values u16[n_esc])
    for the FF 41 alias-mapped variant."""
    if len(blob) < 12 or blob[:2] not in (MICT_MAGIC, MICT_ALIAS_MAGIC):
        raise ValueError("MICT: missing magic bytes")
    is_alias = blob[:2] == MICT_ALIAS_MAGIC
    if is_alias and len(blob) < 18:
        raise ValueError("MICT: truncated alias header")
    log2_lanes, tl_hdr = struct.unpack_from("<BB", blob, 2)
    count, n_words = struct.unpack_from("<II", blob, 4)
    L = 1 << log2_lanes
    hdr = 12
    n_esc = esc_val = 0
    if is_alias:
        n_esc, esc_val = struct.unpack_from("<IH", blob, 12)
        hdr = 18
    norm, symbol_len, table_log, consumed = read_ncount(blob[hdr:])
    if table_log != tl_hdr:
        raise ValueError("MICT: header tableLog mismatch")
    pos = hdr + consumed
    states = np.frombuffer(blob, dtype="<u4", count=L, offset=pos).copy()
    pos += 4 * L
    words = np.frombuffer(blob, dtype="<u2", count=n_words, offset=pos).copy()
    alias = None
    if is_alias:
        pos += 2 * n_words
        if pos + 2 * n_esc > len(blob):
            raise ValueError("MICT: escape stream out of bounds")
        esc_values = np.frombuffer(blob, dtype="<u2", count=n_esc, offset=pos).copy()
        alias = (esc_val, esc_values)
    return L, table_log, count, states, words, norm, symbol_len, alias


def _norm_and_header(counts, n, tl, sl):
    """normalize_count + write_count: (norm, ncount header bytes), the
    same bytes as ``mic_tpu``'s native and numpy pairs."""
    norm = normalize_count(counts, n, tl, sl)
    if int(np.abs(norm).sum()) != (1 << tl):  # reference validateNorm
        raise ValueError("normalize: table does not sum to 1<<tableLog")
    return norm, write_count(norm, sl, tl)


def _alias_plan(counts, symbol_len, kept: int):
    """Folding plan for a symbol stream's tail: keep the ``kept`` most
    frequent values (count desc, value asc); rare occurrences recode as
    ``esc_val`` (the smallest value with zero count).

    Returns (kept_vals, counts2, symbol_len2, esc_val)."""
    nzv = np.nonzero(counts)[0]
    order = np.lexsort((nzv, -counts[nzv]))  # count desc, value asc
    kept_vals = np.sort(nzv[order[:kept]])
    zero = np.nonzero(counts == 0)[0]
    if len(zero):
        esc_val = int(zero[0])
    elif symbol_len <= 65535:
        esc_val = symbol_len
    else:
        raise IncompressibleError("alias: no free symbol value for ESC")
    sl2 = max(int(kept_vals.max()), esc_val) + 1
    counts2 = np.zeros(sl2, np.int64)
    counts2[kept_vals] = counts[kept_vals]
    n_rare = int(counts[nzv].sum() - counts[kept_vals].sum())
    counts2[esc_val] = n_rare
    return kept_vals, counts2, sl2, esc_val


def _alias_apply(symbols, kept_vals, esc_val):
    """Apply a fold plan to the stream: (recoded i64[n], esc_values
    u16 in stream order)."""
    is_kept = np.zeros(65536, bool)
    is_kept[kept_vals] = True
    rare_mask = ~is_kept[symbols]
    esc_values = symbols[rare_mask].astype(np.uint16)
    recoded = np.where(rare_mask, esc_val, symbols).astype(np.int64)
    return recoded, esc_values


def alias_encode_plan(counts, symbol_len, n, table_log, max_table_log=None):
    """The byte-format-defining FF 41 encode setup: kept-reduction retry
    loop, tableLog clamp (at most 12, at least 7), normalization + ncount
    header, tables and the alias layout.  Returns (kept_vals, esc_val,
    tl, header, freq, cumul, al); raises the usual sentinel errors."""
    counts = np.asarray(counts[:symbol_len], dtype=np.int64)
    kept = min(int((counts > 0).sum()), ALIAS_MAX_KEPT)
    while True:
        kept_vals, counts2, sl2, esc_val = _alias_plan(counts, symbol_len, kept)
        tl = optimal_table_log(table_log, n, sl2)
        tl = min(tl, 12 if max_table_log is None else min(max_table_log, 12))
        tl = max(tl, 7)  # 128 buckets need at least 128 slots
        try:
            norm, header = _norm_and_header(counts2, n, tl, sl2)
            freq, cumul = encode_tables(norm, tl)
            al = alias_construct(norm, tl)
            return kept_vals, esc_val, tl, header, freq, cumul, al
        except AliasInfeasible:
            kept -= 64
            if kept < 8:
                raise IncompressibleError("alias layout infeasible")
        except ValueError as e:
            raise IncompressibleError(str(e)) from e
