"""Host decoders of the reference's FSE / tANS streams for 1/2/4/8
interleaved states, the magic-byte dispatch, and the 4-state encoder.

A numpy copy of the decode side of ``mic_tpu.ops.fse_codec`` and of its
4-state encoder (same names, same outputs; the decoders pinned by
``tests/test_torch_tans_decode.py``, the encoder by
``tests/test_torch_mesh.py``; ``dryrun.py`` encodes its tANS streams
with it).
Stream formats (byte-compatible with the reference):

* 1-state: ``[writeCount header][reverse bitstream]`` (fsecompressu16.go:19)
* N-state (N=2,4,8): ``[0xFF][magic][count u32 LE][header][bitstream]``
  where magic is 0x02 / 0x04 / 0x84 (fse2state.go:13, fse4state.go:14,
  fse8state.go:13); 0x08 is the 8-state rANS form (``ops/rans.py``).

Symbols at positions ``i % N == k`` belong to lane *k*; the decoder reads
lane 0's initial state first.  This is the host route of
``tpu/tans_decode.fse_decompress_device_batch``: 1-state streams and
streams past the kernel's caps decode here.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriterLSB, ReverseBitReader
from .fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    build_ctable,
    build_dtable,
    histogram,
    normalize_count,
    optimal_table_log,
    read_ncount,
    write_count,
)
from .rans import DECOMPRESS_LIMIT_DEFAULT, MAGIC_8STATE_RANS, rans_decompress_8state

__all__ = [
    "MAGIC_2STATE",
    "MAGIC_4STATE",
    "MAGIC_8STATE_FSE",
    "MAGIC_8STATE_RANS",
    "DECOMPRESS_LIMIT_DEFAULT",
    "fse_decompress",
    "fse_decompress_2state",
    "fse_decompress_4state",
    "fse_decompress_8state",
    "fse_decompress_auto",
    "fse_compress_4state",
]

MAGIC_2STATE = b"\xff\x02"
MAGIC_4STATE = b"\xff\x04"
MAGIC_8STATE_FSE = b"\xff\x84"


def _prepare_tables(data: np.ndarray, table_log_hint: int):
    """The encoder's front end: histogram, tableLog, normalized counts,
    header; raises UseRLEError / IncompressibleError at the reference's
    gates (fsecompressu16.go:39-45) and on a table that does not sum
    (validateNorm, fsecompressu16.go:58)."""
    n = len(data)
    counts, max_count, symbol_len = histogram(data)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    table_log = optimal_table_log(table_log_hint, n, symbol_len)
    norm = normalize_count(counts, n, table_log, symbol_len)
    if int(np.abs(norm).sum()) != (1 << table_log):
        raise IncompressibleError
    return norm, symbol_len, table_log, write_count(norm, symbol_len, table_log)


def _encode_bitstream(data: np.ndarray, norm: np.ndarray, symbol_len: int, table_log: int,
                      n_states: int) -> bytes:
    """N-lane backwards tANS encode: positions in descending order, position
    i by lane ``i % N`` (every reference variant reduces to this order),
    then the final states, lane N-1 .. 0, tableLog bits each."""
    state_table, delta_nb_bits, delta_find_state, _zero_bits = build_ctable(
        norm, symbol_len, table_log)
    st, dnb, dfs = state_table.tolist(), delta_nb_bits.tolist(), delta_find_state.tolist()
    src = np.asarray(data, dtype=np.uint16).tolist()
    states = [1 << table_log] * n_states
    w = BitWriterLSB()
    vap, wap = w.values.append, w.widths.append
    for i in range(len(src) - 1, -1, -1):
        s = src[i]
        lane = i % n_states
        x = states[lane]
        nb = (x + dnb[s]) >> 16
        vap(x)
        wap(nb)
        states[lane] = st[(x >> nb) + dfs[s]]
    for lane in range(n_states - 1, -1, -1):
        vap(states[lane])
        wap(table_log)
    return w.close()


def fse_compress_4state(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """Four-state FSE compress (reference FSECompressU16FourState,
    fse4state.go:24): ``MAGIC_4STATE``, the count, the header and the
    bitstream."""
    data = np.asarray(data, dtype=np.uint16)
    n = len(data)
    if n <= 3:
        raise IncompressibleError
    if n > (2 << 30) - 1:
        raise ValueError("input too big, must be < 2GB")
    norm, symbol_len, actual_tl, header = _prepare_tables(data, table_log)
    out = header + _encode_bitstream(data, norm, symbol_len, actual_tl, 4)
    if len(out) >= n * 2:
        raise IncompressibleError
    return MAGIC_4STATE + int(n).to_bytes(4, "little") + out


def _decode_bitstream(
    bits: bytes,
    new_state: np.ndarray,
    symbol: np.ndarray,
    nb_bits: np.ndarray,
    table_log: int,
    n_states: int,
    count: int | None,
    limit: int = DECOMPRESS_LIMIT_DEFAULT,
) -> np.ndarray:
    """Generic N-lane forward decode.

    With ``count`` given (N>=2 streams carry an exact count), decodes that
    many symbols round-robin across lanes.  With ``count=None`` (1-state),
    termination follows the reference's finished()/final() protocol
    (fsedecompressu16.go:362-375).
    """
    r = ReverseBitReader(bits)
    ns = new_state.tolist()
    sym = symbol.tolist()
    nb = nb_bits.tolist()
    get = r.get_bits

    if count is not None:
        if count > limit:
            raise ValueError(
                f"declared count ({count}) > DecompressLimit ({limit})"
            )
        states = []
        for _ in range(n_states):
            states.append(get(table_log))
        out = [0] * count
        for i in range(count):
            lane = i % n_states
            x = states[lane]
            out[i] = sym[x]
            states[lane] = ns[x] + get(nb[x])
        return np.array(out, dtype=np.uint16)

    # 1-state: implicit termination.
    x = get(table_log)
    out = []
    ap = out.append
    while True:
        if r.pos <= 0 and nb[x] > 0:
            if x != 0:
                ap(sym[x])
            break
        ap(sym[x])
        x = ns[x] + get(nb[x])
        if len(out) >= limit:
            raise ValueError(f"output size ({len(out)}) > DecompressLimit ({limit})")
    return np.array(out, dtype=np.uint16)


def _decompress_body(
    body: bytes, n_states: int, count: int | None, limit: int
) -> np.ndarray:
    norm, symbol_len, table_log, consumed = read_ncount(body)
    new_state, symbol, nb_bits, _zero_bits = build_dtable(norm, symbol_len, table_log)
    return _decode_bitstream(
        body[consumed:], new_state, symbol, nb_bits, table_log, n_states, count, limit
    )


def fse_decompress(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT) -> np.ndarray:
    """Single-state FSE decompress (reference FSEDecompressU16)."""
    return _decompress_body(data, 1, None, limit)


def _decompress_n_state(data: bytes, magic: bytes, n_states: int, limit: int):
    if len(data) < 6 or data[:2] != magic:
        raise ValueError(f"fse{n_states}state: missing magic bytes")
    count = int.from_bytes(data[2:6], "little")
    return _decompress_body(data[6:], n_states, count, limit)


def fse_decompress_2state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_2STATE, 2, limit)


def fse_decompress_4state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_4STATE, 4, limit)


def fse_decompress_8state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_8STATE_FSE, 8, limit)


def fse_decompress_auto(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    """Magic-byte auto-dispatch (reference FSEDecompressU16Auto,
    fse2state.go:96-116): ``FF 84`` -> 8-state FSE, ``FF 08`` -> 8-state
    rANS, ``FF 04`` -> 4-state, ``FF 02`` -> 2-state, otherwise
    single-state."""
    if len(data) >= 2 and data[:2] == MAGIC_8STATE_FSE:
        return fse_decompress_8state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_8STATE_RANS:
        return rans_decompress_8state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_4STATE:
        return fse_decompress_4state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_2STATE:
        return fse_decompress_2state(data, limit)
    return fse_decompress(data, limit)
