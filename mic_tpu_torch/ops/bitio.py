"""Bit streams of the reference's FSE / rANS and Huffman coders.

A copy of ``mic_tpu.ops.bitio`` (same names, same bytes).  The FSE /
rANS pair is LSB-first: the encoder writes values LSB-first and ends the
stream with a 1 bit in its last byte, so the decoder reads the top
unread bits first (bitwriter.go:162-168, bitreader.go:56-61;
``ReverseBitReader`` pinned by ``tests/test_torch_tans_decode.py``,
``pack_bits_lsb`` / ``BitWriterLSB`` through the encoders by
``tests/test_torch_mesh.py``).  The Huffman pair is MSB-first and read
forwards (bitwriterhuff.go, bitreaderhuff.go; ``pack_bits_msb``,
``BitWriterMSB`` and ``ForwardBitReader`` pinned by
``tests/test_torch_wavelet_huffman_gap.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_bits_lsb", "pack_bits_msb", "BitWriterLSB", "ReverseBitReader",
           "BitWriterMSB", "ForwardBitReader"]


def pack_bits_lsb(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Pack ``values[i]`` (low ``widths[i]`` bits) LSB-first into bytes:
    bit 0 of the stream is the LSB of byte 0 (bitwriter.go:50,151-158;
    the flush timing never changes the bytes, so one vectorized pass is
    bit-identical)."""
    values = np.asarray(values, dtype=np.uint64)
    widths = np.asarray(widths, dtype=np.uint64)
    if values.size == 0:
        return b""
    mask = np.where(
        widths >= 64, np.uint64(0xFFFFFFFFFFFFFFFF), (np.uint64(1) << widths) - np.uint64(1)
    )
    values = values & mask
    ends = np.cumsum(widths, dtype=np.uint64)
    starts = ends - widths
    total_bits = int(ends[-1])
    nwords = (total_bits + 63) // 64 + 1  # +1 spill word
    words = np.zeros(nwords, dtype=np.uint64)
    word_idx = (starts >> np.uint64(6)).astype(np.int64)
    shift = starts & np.uint64(63)
    lo = values << shift
    # High spill: v >> (64 - s); a shift of 64 is undefined, so gate s == 0.
    inv = (np.uint64(64) - shift) & np.uint64(63)
    hi = np.where(shift == 0, np.uint64(0), values >> inv)
    np.bitwise_or.at(words, word_idx, lo)
    np.bitwise_or.at(words, word_idx + 1, hi)
    return words.tobytes()[: (total_bits + 7) // 8]


def pack_bits_msb(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Pack values MSB-first (Huffman convention): the first value's MSB is
    the MSB of byte 0 (reference: bitwriterhuff.go:19-51)."""
    values = np.asarray(values, dtype=np.uint64)
    widths = np.asarray(widths, dtype=np.uint64)
    if values.size == 0:
        return b""
    mask = np.where(
        widths >= 64, np.uint64(0xFFFFFFFFFFFFFFFF), (np.uint64(1) << widths) - np.uint64(1)
    )
    values = values & mask
    ends = np.cumsum(widths, dtype=np.uint64)
    starts = ends - widths
    total_bits = int(ends[-1])
    nbits_padded = (total_bits + 63) // 64 * 64 + 64
    nwords = nbits_padded // 64
    words = np.zeros(nwords, dtype=np.uint64)
    # Bit position b (MSB-first) lives in word b//64 at bit offset (63 - b%64)
    # counted from the LSB.  A value occupying [start, end) has its LSB at
    # stream position end-1.
    word_idx = (starts >> np.uint64(6)).astype(np.int64)
    off = starts & np.uint64(63)  # MSB offset within word
    # Left-justify: value << (64 - off - width), spilling into the next word.
    sh = np.int64(64) - off.astype(np.int64) - widths.astype(np.int64)
    lo_sh = np.where(sh >= 0, sh, 0).astype(np.uint64)
    in_word = values << lo_sh
    in_word = np.where(sh >= 0, in_word, values >> ((-np.minimum(sh, 0)).astype(np.uint64)))
    spill_sh = (np.int64(64) + sh).astype(np.uint64)  # only used when sh < 0
    spill = np.where(sh < 0, values << (spill_sh & np.uint64(63)), np.uint64(0))
    np.bitwise_or.at(words, word_idx, in_word)
    np.bitwise_or.at(words, word_idx + 1, spill)
    data = words.byteswap().tobytes()  # big-endian within each word
    nbytes = (total_bits + 7) // 8
    return data[:nbytes]


class BitWriterLSB:
    """Accumulating LSB-first bit writer: (value, width) pairs;
    :meth:`close` appends the end-mark bit and byte-aligns
    (bitwriter.go:162-168)."""

    __slots__ = ("values", "widths")

    def __init__(self) -> None:
        self.values: list[int] = []
        self.widths: list[int] = []

    def close(self) -> bytes:
        self.values.append(1)
        self.widths.append(1)
        return pack_bits_lsb(
            np.array(self.values, dtype=np.uint64), np.array(self.widths, dtype=np.uint64)
        )


class ReverseBitReader:
    """Reads an FSE stream in reverse (last-written bits first).

    Models the stream as an exact big integer of ``total_bits`` usable bits
    (everything below the end-mark).  ``get_bits(n)`` returns the top *n*
    unread bits.
    """

    __slots__ = ("data", "pos", "total_bits")

    def __init__(self, data: bytes) -> None:
        if len(data) < 1:
            raise ValueError("corrupt stream: too short")
        last = data[-1]
        if last == 0:
            raise ValueError("corrupt stream, did not find end of stream")
        # bit_length-1 = index of the end mark; usable bits are those below it.
        total_bits = 8 * (len(data) - 1) + (last.bit_length() - 1)
        self.data = data
        self.total_bits = total_bits
        self.pos = total_bits  # bits remaining

    def get_bits(self, n: int) -> int:
        """Read the next n bits (the most recently written unread bits),
        from a 6-byte window (n <= 32 for FSE / rANS streams)."""
        if n == 0:
            return 0
        pos = self.pos - n
        self.pos = pos
        if pos < 0:
            # Over-read: zero-fill below the stream start (the safe decode
            # paths in the reference read zeros once exhausted).
            chunk = int.from_bytes(self.data[0:6], "little")
            return (chunk << -pos) & ((1 << n) - 1)
        chunk = int.from_bytes(self.data[pos >> 3 : (pos >> 3) + 6], "little")
        return (chunk >> (pos & 7)) & ((1 << n) - 1)


class BitWriterMSB:
    """Accumulating MSB-first bit writer (Huffman convention)."""

    __slots__ = ("values", "widths")

    def __init__(self) -> None:
        self.values: list[int] = []
        self.widths: list[int] = []

    def add_bits(self, value: int, nbits: int) -> None:
        self.values.append(value)
        self.widths.append(nbits)

    def flush_align(self) -> bytes:
        return pack_bits_msb(
            np.array(self.values, dtype=np.uint64), np.array(self.widths, dtype=np.uint64)
        )


class ForwardBitReader:
    """Forward MSB-first bit reader (Huffman convention).

    Mirrors ``bitReaderHuff`` (bitreaderhuff.go:26-117): reads the stream
    front-to-back, returning the next n bits with the earliest bit as MSB.
    Reads past the end return zero bits (the encoder pads with zeros).
    """

    __slots__ = ("data", "pos", "total_bits")

    def __init__(self, data: bytes) -> None:
        self.total_bits = 8 * len(data)
        # Zero-pad the tail so 6-byte windows never fall short; reads past
        # the end return zero bits (the encoder zero-pads, canhuffman…go:77-79).
        self.data = data + b"\x00" * 8
        self.pos = 0

    def get_bits(self, n: int) -> int:
        """Read the next n bits MSB-first, from a 6-byte window (n <= 32:
        maxCodeLen + pixelDepth <= 32 is checked by the encoder)."""
        if n == 0:
            return 0
        pos = self.pos
        self.pos = pos + n
        b0 = pos >> 3
        chunk = int.from_bytes(self.data[b0 : b0 + 6], "big")
        return (chunk >> (48 - (pos & 7) - n)) & ((1 << n) - 1)
