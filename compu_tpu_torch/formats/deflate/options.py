"""zlib/deflate encode options (the port's copy of the encode side of
``compu_tpu/formats/deflate/options.py``, with only the fields the device
encode reads)."""

from __future__ import annotations

import dataclasses
import enum
import struct


class ZlibMode(enum.Enum):
    """Framing of an encoded stream."""

    Deflate = "deflate"  # raw RFC1951, no framing
    Zlib = "zlib"        # RFC1950: 2-byte header + adler32
    Gzip = "gzip"        # RFC1952: gzip header + crc32 + isize


@dataclasses.dataclass(frozen=True)
class ZlibOptions:
    """Encoder options: the framing, and ``level`` 0..9, which picks the
    device matcher's ladder rung."""

    mode: ZlibMode = ZlibMode.Zlib
    level: int = 6

    def __post_init__(self) -> None:
        if not 0 <= self.level <= 9:
            raise ValueError("compression level must be in 0..9")


def stream_header(mode: ZlibMode, level: int) -> bytes:
    """The stream header of ``mode``, with the level hint (zlib FLEVEL,
    gzip XFL) of ``level``; a raw deflate stream has none."""
    if mode is ZlibMode.Zlib:
        cmf = 0x78  # method 8, 32 KiB window
        flg = (0, 0, 0, 1, 1, 1, 2, 2, 3, 3)[level] << 6
        fcheck = (31 - ((cmf << 8 | flg) % 31)) % 31
        return bytes([cmf, flg | fcheck])
    if mode is ZlibMode.Gzip:
        xfl = 2 if level >= 9 else (4 if level <= 2 else 0)
        # mtime 0 keeps chunked == one-shot deterministic.
        return struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, 0, 0, xfl, 255)
    return b""
