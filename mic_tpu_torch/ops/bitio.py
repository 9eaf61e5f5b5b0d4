"""Reverse bit reader of the reference's FSE / rANS streams.

A copy of ``mic_tpu.ops.bitio.ReverseBitReader`` (same name, same
reads; pinned by ``tests/test_torch_tans_decode.py``).  The encoder
writes values LSB-first and ends the stream with a 1 bit in its last
byte, so the decoder reads the top unread bits first (bitreader.go:56-61).
"""

from __future__ import annotations

__all__ = ["ReverseBitReader"]


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
