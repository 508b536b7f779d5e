"""Fixed-size staging buffer for chunked drivers: the port's copy of
``compu_tpu/buffer.py``.

A fixed byte array plus a cursor. Codecs write into the spare region, the
user drains ``data()`` and ``consume()``s.
"""

from __future__ import annotations

from .status import Decode, Encode, EncodeOp

MIN_SIZE = 128  # the smallest buffer a codec is given


class Buffer:
    """Fixed-capacity staging buffer with a write cursor."""

    __slots__ = ("_buf", "_cursor")

    def __init__(self, size: int = 4096) -> None:
        if size < MIN_SIZE:
            raise ValueError(f"Buffer size must be >= {MIN_SIZE}")
        self._buf = bytearray(size)
        self._cursor = 0

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def __len__(self) -> int:
        return self._cursor

    def data(self) -> bytes:
        """The written prefix."""
        return bytes(self._buf[: self._cursor])

    def consume(self) -> None:
        """Reset the cursor, discarding staged data."""
        self._cursor = 0

    def spare_capacity_mut(self) -> memoryview:
        """Writable region after the cursor."""
        return memoryview(self._buf)[self._cursor :]

    def encode(self, encoder, input_data, op: EncodeOp) -> tuple[int, "Encode"]:
        """Encode ``input_data`` into this buffer's spare capacity.

        Returns ``(bytes_consumed, Encode)`` so the caller can advance its
        input slice.
        """
        spare = self.spare_capacity_mut()
        result = encoder.encode(input_data, spare, op)
        written = len(spare) - result.output_remain
        self._cursor += written
        consumed = len(input_data) - result.input_remain
        return consumed, result

    def decode(self, decoder, input_data) -> tuple[int, "Decode"]:
        """Decode ``input_data`` into this buffer's spare capacity; returns
        ``(bytes_consumed, Decode)``."""
        spare = self.spare_capacity_mut()
        result = decoder.decode(input_data, spare)
        written = len(spare) - result.output_remain
        self._cursor += written
        consumed = len(input_data) - result.input_remain
        return consumed, result
