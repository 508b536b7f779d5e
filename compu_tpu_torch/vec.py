"""Growable byte vector with explicit capacity (the port's copy of the part
of ``compu_tpu/vec.py::ByteVec`` the encoder uses).

The encoder writes only into a caller's spare capacity (``encode_vec``) or
grows the vector as it goes (``encode_vec_full``), so capacity is modelled
apart from length.
"""

from __future__ import annotations


class ByteVec:
    """A byte vector with separate length and capacity.

    ``data`` is the initialized prefix; ``spare_capacity_mut`` is the
    writable region an encoder fills.
    """

    __slots__ = ("_buf", "_len")

    def __init__(self, initial: bytes = b"") -> None:
        self._buf = bytearray(initial)
        self._len = len(initial)

    def __len__(self) -> int:
        return self._len

    def reserve_exact(self, additional: int) -> None:
        """Ensure at least ``additional`` bytes of spare capacity."""
        need = self._len + additional - len(self._buf)
        if need > 0:
            self._buf.extend(b"\0" * need)

    def data(self) -> bytes:
        return bytes(self._buf[: self._len])

    def spare_capacity_mut(self) -> memoryview:
        return memoryview(self._buf)[self._len :]

    def add_len(self, delta: int) -> None:
        new_len = self._len + delta
        if not 0 <= new_len <= len(self._buf):
            raise ValueError("length beyond capacity")
        self._len = new_len
