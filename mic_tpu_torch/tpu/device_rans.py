"""Host side of the wide-lane rANS device format (MICT, FF 57 / FF 41).

A jax-free copy of the parts of ``mic_tpu.tpu.device_rans`` the port
needs.  Decode: the stream parser and the slot / alias tables the decode
kernels' operands are made from, and the host decoder
(``mict_decode_numpy`` with ``alias_substitute_escapes``), the oracle of
the single-stream path.  Encode: the normalization + ncount header
(``_norm_and_header``) and the alias escape-fold plan (``_alias_plan`` /
``_alias_apply`` / ``alias_encode_plan``) that define an encoded blob's
bytes, which the device encoder shares; and the host encoder at any lane
count (``mict_encode`` / ``mict_encode_alias`` over ``_lane_encode``),
which the host ``strips.micw_compress`` writes containers with.  As in
``mic_tpu`` with its library built, the three host hot spots run the C++
tier (``..native``): ``_norm_and_header`` (normalization + ncount
header), ``_lane_encode`` (the L-lane rANS encode) and ``mict_parse``'s
ncount reader.  Their numpy twins (``_norm_and_header_numpy``,
``_lane_encode_numpy``, ``..ops.fse.read_ncount``) run only where the
native call returns ``None`` for a reason of the data, as ``mic_tpu``'s
do, for lane encodes past the C++ loop's shapes (``_lane_encode``), and
in the tests.  The copies here are pinned to the originals by
``tests/test_torch_host_format.py``, ``tests/test_torch_rans_encode.py``,
``tests/test_torch_scan_decode.py`` and ``tests/test_torch_native.py``.

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

from ..native import lane_encode_native, normalize_write_count_native, read_ncount_native
from ..ops.fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    histogram,
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
    "mict_encode",
    "mict_encode_alias",
    "mict_decode_numpy",
    "alias_substitute_escapes",
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


def _hist_or_counts(symbols: np.ndarray, counts: np.ndarray | None):
    """histogram(), or (counts, max_count, symbol_len) from a
    caller-supplied bincount (the trial-set encoders bincount every
    candidate for the size estimate already)."""
    if counts is None:
        return histogram(symbols)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    if symbols.size and int(symbols.max()) >= counts.size:
        # A mismatched bincount would write a blob that decodes wrong.
        raise ValueError("counts shorter than the symbol range")
    return counts, int(counts.max()) if counts.size else 0, int(counts.size)


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
    sym, freq_slot, bias_slot = alias_slot_expand(alias_construct(norm, table_log), table_log)
    freqs, cumul = encode_tables(norm, table_log)
    return sym, freq_slot, bias_slot, freqs, cumul


def alias_slot_expand(al: dict, table_log: int):
    """The (sym, freq, bias) slot tables of :func:`alias_slot_tables` from
    an alias layout ``al`` (:func:`alias_construct`'s dict) built once."""
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
    return sym, freq_slot, bias_slot


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
    body = blob[hdr:]
    # The native reader returns None on an invalid header: the Python
    # reader then raises its error, as in mic_tpu.  Its int32 norm widens
    # to the Python reader's int64, so the tables built from it are too.
    nat = read_ncount_native(body)
    if nat is not None:
        norm, symbol_len, table_log, consumed = nat
        norm = norm.astype(np.int64)
    else:
        norm, symbol_len, table_log, consumed = read_ncount(body)
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


def mict_encode(
    symbols,
    lanes: int | None = None,
    table_log: int = DEFAULT_TABLE_LOG,
    max_table_log: int | None = None,
    max_bytes: int | None = None,
    alias: bool = False,
    counts: np.ndarray | None = None,
) -> bytes:
    """Encode a u16 symbol stream into the MICT wide-lane rANS format at
    ``lanes`` lanes (default 512 for FF 57, 128 for FF 41);
    ``alias=True`` writes the FF 41 variant (:func:`mict_encode_alias`).
    ``max_table_log`` caps the adaptive tableLog; the blob must be
    shorter than ``max_bytes`` (default: the stream's raw size), else
    IncompressibleError."""
    if lanes is None:
        lanes = 128 if alias else 512
    if alias:
        return mict_encode_alias(
            symbols, lanes=lanes, table_log=table_log,
            max_table_log=max_table_log, max_bytes=max_bytes, counts=counts,
        )
    symbols = np.asarray(symbols, dtype=np.uint16)
    n = len(symbols)
    if n == 0:
        raise IncompressibleError
    counts, max_count, symbol_len = _hist_or_counts(symbols, counts)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    tl = optimal_table_log(table_log, n, symbol_len)
    if max_table_log is not None and tl > max_table_log:
        tl = max_table_log
    try:
        norm, header = _norm_and_header(counts, n, tl, symbol_len)
        freq, cumul = encode_tables(norm, tl)
    except ValueError as e:
        # Alphabet too wide for the clamped tableLog (tiny inputs).
        raise IncompressibleError(str(e)) from e

    states, words = _lane_encode(symbols.astype(np.int64), n, int(lanes), tl, freq, cumul)

    out = bytearray()
    out += MICT_MAGIC
    out += struct.pack("<BB", int(np.log2(int(lanes))), tl)
    out += struct.pack("<II", n, len(words))
    out += header
    out += states.astype("<u4").tobytes()
    out += words.astype("<u2").tobytes()
    if len(out) >= (n * 2 if max_bytes is None else max_bytes):
        raise IncompressibleError
    return bytes(out)


def _norm_and_header(counts, n, tl, sl):
    """normalize_count + write_count: (norm, ncount header bytes) from
    the C++ tier; where it needs the retry it leaves to its caller
    (``None``), the numpy pair, which then raises, as in ``mic_tpu``."""
    nat = normalize_write_count_native(counts, n, tl, sl)
    if nat is not None:
        return nat
    return _norm_and_header_numpy(counts, n, tl, sl)


def _norm_and_header_numpy(counts, n, tl, sl):
    """The numpy twin of ``_norm_and_header``: the same bytes."""
    norm = normalize_count(counts, n, tl, sl)
    if int(np.abs(norm).sum()) != (1 << tl):  # reference validateNorm
        raise ValueError("normalize: table does not sum to 1<<tableLog")
    return norm, write_count(norm, sl, tl)


# mic_lane_encode's shapes (micfse.cpp:1264): it refuses more lanes or a
# larger tableLog, and so does mic_tpu's encode with its library built.
NATIVE_MAX_LANES, NATIVE_MAX_TABLE_LOG = 4096, 15


def _lane_encode(sym_i64, n, L, tl, freq_of, cumul_of, slot_of=None):
    """Reverse lane-interleaved rANS encode shared by the standard and
    alias paths (the slot written is cumul + j, or slot_of[cumul + j]
    with the alias permutation), on the C++ tier (``mic_lane_encode``).
    Returns (states u64[L], words u16) in decoder order (step ascending,
    lane ascending).  Streams past the C++ loop's shapes (more than
    ``NATIVE_MAX_LANES`` lanes, tableLog 16), which the port's host
    encoder writes for the scan tier as ``mic_tpu``'s numpy tier does,
    take the numpy twin."""
    if L > NATIVE_MAX_LANES or tl > NATIVE_MAX_TABLE_LOG:
        return _lane_encode_numpy(sym_i64, n, L, tl, freq_of, cumul_of, slot_of)
    states, words = lane_encode_native(np.asarray(sym_i64[:n], dtype=np.uint16), int(L),
                                       int(tl), freq_of, cumul_of, slot_of)
    return states.astype(np.uint64), words


def _lane_encode_numpy(sym_i64, n, L, tl, freq_of, cumul_of, slot_of=None):
    """The numpy twin of ``_lane_encode``: the same states and words."""
    n_steps = (n + L - 1) // L
    states = np.full(L, RANS_L, dtype=np.uint64)
    # Renorm bound: emit while x >= freq << (32 - tl)  (single-word renorm).
    shift = 32 - tl

    step_words: list[np.ndarray] = []
    lane_idx = np.arange(L)

    for t in range(n_steps - 1, -1, -1):
        base = t * L
        cnt = min(L, n - base)
        s = sym_i64[base : base + cnt]
        if cnt < L:
            active = lane_idx < cnt
            s_full = np.zeros(L, dtype=np.int64)
            s_full[:cnt] = s
        else:
            active = None
            s_full = s
        f = freq_of[s_full].astype(np.uint64)
        c = cumul_of[s_full].astype(np.uint64)
        if active is not None:
            f = np.where(active, f, np.uint64(1))  # avoid div-by-zero on pad lanes
        x = states
        x_max = f << np.uint64(shift)
        need = x >= x_max
        if active is not None:
            need &= active
        if need.any():
            # Steps are emitted in reverse and the list reversed at the end.
            step_words.append((x[need] & np.uint64(0xFFFF)).astype(np.uint16))
            x = np.where(need, x >> np.uint64(16), x)
        if slot_of is not None:
            x_new = ((x // f) << np.uint64(tl)) + slot_of[(x % f) + c]
        else:
            x_new = ((x // f) << np.uint64(tl)) + (x % f) + c
        if active is not None:
            x_new = np.where(active, x_new, x)
        states = x_new

    words = (
        np.concatenate(step_words[::-1]) if step_words else np.zeros(0, dtype=np.uint16)
    )
    return states, words


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


def mict_encode_alias(
    symbols,
    lanes: int = 128,
    table_log: int = DEFAULT_TABLE_LOG,
    max_table_log: int | None = None,
    max_bytes: int | None = None,
    counts: np.ndarray | None = None,
) -> bytes:
    """Encode into the alias-mapped MICT variant (magic FF 41): the
    slots permuted per alias_construct, alphabets beyond 256 escape-folded
    into one ESC symbol whose true values ride the uncoded side stream.

    Layout:  FF 41 | log2_lanes u8 | table_log u8 | count u32 |
    n_words u32 | n_esc u32 | esc_val u16 | ncount | init states |
    renorm words | esc values u16[n_esc]."""
    symbols = np.asarray(symbols, dtype=np.uint16)
    n = len(symbols)
    if n == 0:
        raise IncompressibleError
    counts, max_count, symbol_len = _hist_or_counts(symbols, counts)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    kept_vals, esc_val, tl, header, freq, cumul, al = alias_encode_plan(
        counts, symbol_len, n, table_log, max_table_log
    )
    recoded, esc_values = _alias_apply(symbols, kept_vals, esc_val)
    states, words = _lane_encode(
        recoded, n, int(lanes), tl, freq, cumul,
        slot_of=al["slot_of"].astype(np.uint64),
    )

    out = bytearray()
    out += MICT_ALIAS_MAGIC
    out += struct.pack("<BB", int(np.log2(int(lanes))), tl)
    out += struct.pack("<II", n, len(words))
    out += struct.pack("<IH", len(esc_values), esc_val)
    out += header
    out += states.astype("<u4").tobytes()
    out += words.astype("<u2").tobytes()
    out += esc_values.astype("<u2").tobytes()
    if len(out) >= (n * 2 if max_bytes is None else max_bytes):
        raise IncompressibleError
    return bytes(out)


def mict_decode_numpy(blob: bytes) -> np.ndarray:
    """Host (numpy) decoder of one MICT stream, any lane count: the
    oracle of the lanes kernel and of ``decode.mict_decode_device``.
    Raises ValueError on a stream whose final states, word count or
    escape count are wrong."""
    L, tl, count, states, words, norm, _symbol_len, alias = mict_parse(blob)
    sym, freq_slot, bias_slot, _, _ = slot_tables(norm, tl, alias)
    mask = (1 << tl) - 1

    n_steps = (count + L - 1) // L
    x = states.astype(np.uint64)
    cursor = 0
    out = np.empty(n_steps * L, dtype=np.uint16)
    lane_idx = np.arange(L)
    words_u64 = words.astype(np.uint64)
    for t in range(n_steps):
        base = t * L
        active = lane_idx < (count - base)
        slot = (x & mask).astype(np.int64)
        out[base : base + L] = sym[slot]
        f = freq_slot[slot].astype(np.uint64)
        b = bias_slot[slot].astype(np.uint64)
        x_new = f * (x >> np.uint64(tl)) + b
        need = (x_new < RANS_L) & active
        k = np.cumsum(need) - need  # exclusive prefix sum
        idx = cursor + k
        w = (words_u64[np.minimum(idx, len(words_u64) - 1)] if len(words_u64)
             else np.zeros(L, np.uint64))
        x_new = np.where(need, (x_new << np.uint64(16)) | w, x_new)
        cursor += int(need.sum())
        x = np.where(active, x_new, x)
    if not np.all(x == RANS_L):
        raise ValueError("MICT: final state mismatch (corrupt stream)")
    if cursor != len(words):
        raise ValueError("MICT: word count mismatch (corrupt stream)")
    out = out[:count]
    if alias is not None:
        out = alias_substitute_escapes(out, alias)
    return out


def alias_substitute_escapes(syms: np.ndarray, alias) -> np.ndarray:
    """Replace decoded ESC symbols with their true values from the alias
    side stream, in stream order.  The count check runs even with an
    empty side stream: a forged n_esc = 0 on a stream that decodes ESC
    placeholders fails instead of leaving them in the output."""
    esc_val, esc_values = alias
    idx = np.nonzero(syms == esc_val)[0]
    if len(idx) != len(esc_values):
        raise ValueError("MICT: escape count mismatch (corrupt stream)")
    if not len(idx):
        return syms
    syms = syms.copy()
    syms[idx] = esc_values
    return syms
