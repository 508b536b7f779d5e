"""LSB-first bit fields (DEFLATE bit order): the port's copy of
``compu_tpu/ops/bitio.py``.

Writing is data-parallel: a token stream becomes (value, nbits) arrays,
the bit offsets are a prefix sum, and each value is shifted into a 5-byte
window and OR-ed into the output (``pack_bits``; ``BitWriter`` gathers
the fields of a header). ``BitReader`` reads a field at a time, for the
host inflate and the parse of a block header
(``kernels/inflate_dyn.py::parse_block_tables``).
"""

from __future__ import annotations

import numpy as np


def pack_bits(values: np.ndarray, nbits: np.ndarray, prefix_bits: int = 0, prefix_byte: int = 0):
    """Pack LSB-first bit fields into bytes.

    ``values[i]`` occupies ``nbits[i]`` bits (values may be up to 33 bits —
    litlen/dist code + extra packed together stay below that).
    ``prefix_bits``/``prefix_byte`` continue a stream whose last byte was
    partial (bit-level continuation across block-pipeline calls).

    Returns ``(full_bytes, tail_bits, tail_byte)`` where ``tail_bits`` bits
    of ``tail_byte`` are the new partial byte.
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if len(values) == 0:
        return b"", prefix_bits, prefix_byte
    offsets = prefix_bits + np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(nbits)[:-1]]
    )
    total_bits = int(prefix_bits + nbits.sum())
    nbytes = (total_bits + 7) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)  # slack for 5-byte windows
    out[0] = prefix_byte
    shifted = values << (offsets % 8).astype(np.uint64)
    bytepos = (offsets // 8).astype(np.int64)
    for k in range(5):
        np.bitwise_or.at(out, bytepos + k, ((shifted >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8))
    tail_bits = total_bits % 8
    if tail_bits:
        return out[: nbytes - 1].tobytes(), tail_bits, int(out[nbytes - 1])
    return out[:nbytes].tobytes(), 0, 0


def reverse_bits(codes: np.ndarray, lengths: np.ndarray, max_bits: int = 15) -> np.ndarray:
    """Bit-reverse each code within its length (DEFLATE writes Huffman codes
    MSB-first while the stream is LSB-first, so codes are emitted reversed)."""
    codes = np.asarray(codes, dtype=np.uint32)
    lengths = np.asarray(lengths, dtype=np.uint32)
    rev = np.zeros_like(codes)
    c = codes.copy()
    for _ in range(max_bits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    # rev now holds the code reversed within max_bits; shift down to length.
    return rev >> (max_bits - lengths).astype(np.uint32)


class BitWriter:
    """Gathers (value, nbits) pushes for :func:`pack_bits`: the host
    header writers' fields (token bodies are packed from arrays)."""

    def __init__(self) -> None:
        self.values: list[int] = []
        self.nbits: list[int] = []

    def push(self, value: int, nbits: int) -> None:
        self.values.append(value & ((1 << nbits) - 1) if nbits else 0)
        self.nbits.append(nbits)

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.asarray(self.values, dtype=np.uint64),
            np.asarray(self.nbits, dtype=np.int64),
        )


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
