"""LSB-first bit reading (DEFLATE bit order): the port's copy of the read
half of ``compu_tpu/ops/bitio.py``, which the host parse of a block header
(``kernels/inflate_dyn.py::parse_block_tables``) uses."""

from __future__ import annotations


class BitReader:
    """Scalar LSB-first bit reader over a byte buffer.

    Raises ``NeedMoreBits`` past the end."""

    __slots__ = ("data", "bitpos", "nbits_total")

    def __init__(self, data, bitpos: int = 0) -> None:
        self.data = data
        self.bitpos = bitpos
        self.nbits_total = len(data) * 8

    def read(self, n: int) -> int:
        if self.bitpos + n > self.nbits_total:
            raise NeedMoreBits()
        result = 0
        got = 0
        pos = self.bitpos
        while got < n:
            byte = self.data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n - got)
            bits = (byte >> (pos & 7)) & ((1 << take) - 1)
            result |= bits << got
            got += take
            pos += take
        self.bitpos = pos
        return result

    def peek(self, n: int) -> int:
        """Read up to ``n`` bits without consuming; missing bits are zero."""
        result = 0
        got = 0
        pos = self.bitpos
        while got < n and pos < self.nbits_total:
            byte = self.data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n - got)
            bits = (byte >> (pos & 7)) & ((1 << take) - 1)
            result |= bits << got
            got += take
            pos += take
        return result

    def skip(self, n: int) -> None:
        if self.bitpos + n > self.nbits_total:
            raise NeedMoreBits()
        self.bitpos += n

    def align_byte(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7

    def remaining_bits(self) -> int:
        return self.nbits_total - self.bitpos


class NeedMoreBits(Exception):
    """The buffer ended mid-unit."""
