"""zlib/deflate options: the port's copy of
``compu_tpu/formats/deflate/options.py``, and the stream header that the
framing writes from them."""

from __future__ import annotations

import dataclasses
import enum
import struct


class ZlibMode(enum.Enum):
    """Framing of a stream. ``Auto`` (decode only) sniffs zlib vs gzip."""

    Deflate = "deflate"  # raw RFC1951, no framing
    Zlib = "zlib"        # RFC1950: 2-byte header + adler32
    Gzip = "gzip"        # RFC1952: gzip header + crc32 + isize
    Auto = "auto"        # decode-side header auto-detection


class ZlibStrategy(enum.Enum):
    """Encoding strategies of the host encoders."""

    Default = "default"
    #: Favor literals over short/far matches (filtered/PNG-style data).
    Filtered = "filtered"
    #: Entropy coding only, no LZ77 matches.
    HuffmanOnly = "huffman_only"
    #: Only distance-1 matches (run-length encoding).
    Rle = "rle"
    #: Fixed Huffman tables only (no dynamic blocks).
    Fixed = "fixed"


@dataclasses.dataclass(frozen=True)
class ZlibOptions:
    """Encoder options: the framing; ``level`` 0..9, the match finder's
    effort (0 = stored blocks only; on the device, the matcher's ladder
    rung); and, for the host encoders, ``strategy`` and ``mem_level``,
    which sizes the match finder's hash (mem_level + 8 bits, zlib's
    memLevel: smaller values collide more; 8 is the full 16-bit hash)."""

    mode: ZlibMode = ZlibMode.Zlib
    level: int = 6
    strategy: ZlibStrategy = ZlibStrategy.Default
    mem_level: int = 8

    def __post_init__(self) -> None:
        if not 0 <= self.level <= 9:
            raise ValueError("compression level must be in 0..9")
        if not 1 <= self.mem_level <= 9:
            raise ValueError("mem_level must be in 1..9")
        if self.mode is ZlibMode.Auto:
            raise ValueError("Auto mode is decode-only")


@dataclasses.dataclass(frozen=True)
class ZlibDecodeOptions:
    """Decoder options: the framing to expect (``Auto`` sniffs it)."""

    mode: ZlibMode = ZlibMode.Auto


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
