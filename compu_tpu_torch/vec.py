"""Byte sinks with explicit capacity (the port's copy of
``compu_tpu/vec.py``).

``ByteVec`` models capacity apart from length: the encoder writes only into
a caller's spare capacity (``encode_vec``) or grows the vector as it goes
(``encode_vec_full``). ``ChunkedSink`` lends chunks of its own storage to
``encode_buf``/``decode_buf``, which write in place.
"""

from __future__ import annotations


class ByteVec:
    """A byte vector with separate length and capacity.

    ``data`` is the initialized prefix; ``spare_capacity_mut`` is the
    writable region a codec fills.
    """

    __slots__ = ("_buf", "_len")

    def __init__(self, initial: bytes = b"") -> None:
        self._buf = bytearray(initial)
        self._len = len(initial)

    def __len__(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return len(self._buf)

    @property
    def spare(self) -> int:
        """Number of writable bytes after the initialized prefix."""
        return len(self._buf) - self._len

    def reserve_exact(self, additional: int) -> None:
        """Ensure at least ``additional`` bytes of spare capacity."""
        need = self._len + additional - len(self._buf)
        if need > 0:
            self._buf.extend(b"\0" * need)

    def reserve(self, additional: int) -> None:
        self.reserve_exact(additional)

    def data(self) -> bytes:
        return bytes(self._buf[: self._len])

    def spare_capacity_mut(self) -> memoryview:
        return memoryview(self._buf)[self._len :]

    def set_len(self, new_len: int) -> None:
        if not 0 <= new_len <= len(self._buf):
            raise ValueError("set_len beyond capacity")
        self._len = new_len

    def add_len(self, delta: int) -> None:
        self.set_len(self._len + delta)

    def clear(self) -> None:
        self._len = 0

    def extend(self, data: bytes) -> None:
        self.reserve_exact(len(data))
        self._buf[self._len : self._len + len(data)] = data
        self._len += len(data)


class ChunkedSink:
    """A chunk-lending output sink: ``chunk_mut()`` lends a mutable view of
    the current chunk's free bytes (a new chunk when it is full), and
    ``advance_mut(n)`` commits ``n`` of them. Chunks are not contiguous;
    a codec writes into them in place, with no staging copy."""

    def __init__(self, chunk_size: int = 65_536) -> None:
        if chunk_size < 128:
            raise ValueError("chunk_size must be >= 128")
        self._chunk_size = chunk_size
        self._chunks: list[bytearray] = []
        self._fill: list[int] = []

    def chunk_mut(self) -> memoryview:
        """Mutable view of the current chunk's spare bytes."""
        if not self._chunks or self._fill[-1] == len(self._chunks[-1]):
            self._chunks.append(bytearray(self._chunk_size))
            self._fill.append(0)
        return memoryview(self._chunks[-1])[self._fill[-1] :]

    def advance_mut(self, n: int) -> None:
        if not self._chunks:
            if n:
                raise ValueError("advance_mut before chunk_mut")
            return
        if not 0 <= n <= len(self._chunks[-1]) - self._fill[-1]:
            raise ValueError("advance_mut beyond lent chunk")
        self._fill[-1] += n

    def __len__(self) -> int:
        return sum(self._fill)

    def chunks(self) -> list[bytes]:
        """The committed chunks, in order."""
        return [bytes(c[:f]) for c, f in zip(self._chunks, self._fill)]

    def data(self) -> bytes:
        return b"".join(self.chunks())
