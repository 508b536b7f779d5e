"""Format sniffer: the port's copy of ``compu_tpu/detection.py``.

* fewer than 2 bytes (or fewer than 4 once the zstd check is reached)
  → ``None`` ("cannot tell yet");
* gzip magic ``0x1f 0x8b`` (big-endian u16 0x1f8b);
* zlib 2-byte header: big-endian ``(CMF<<8)|FLG`` divisible by 31, with
  method 8 (deflate) and window bits ≤ 7;
* zstd frame magic ``0xFD2FB528`` little-endian;
* brotli has no magic and is NOT detectable: brotli streams detect as
  ``Unknown``.

A pure host function over the first bytes of a stream.
"""

from __future__ import annotations

import enum
from typing import Optional

ZSTD_MAGIC = 0xFD2FB528
GZIP_MAGIC = 0x1F8B


class Detection(enum.Enum):
    Zstd = "zstd"
    Zlib = "zlib"
    Gzip = "gzip"
    Unknown = "unknown"

    @staticmethod
    def detect(data: bytes) -> Optional["Detection"]:
        """Sniff the stream format from its first bytes.

        Returns ``None`` when too few bytes are available to decide,
        ``Detection.Unknown`` when every check was exhausted.
        """
        if len(data) < 2:
            return None
        word = (data[0] << 8) | data[1]
        if word == GZIP_MAGIC:
            return Detection.Gzip
        if _is_zlib_header(data[0], data[1]):
            return Detection.Zlib
        if len(data) < 4:
            return None
        magic_le = int.from_bytes(data[:4], "little")
        if magic_le == ZSTD_MAGIC:
            return Detection.Zstd
        return Detection.Unknown


def _is_zlib_header(cmf: int, flg: int) -> bool:
    # FCHECK rule: the big-endian 16-bit header is a multiple of 31 (RFC1950).
    if ((cmf << 8) | flg) % 31 != 0:
        return False
    # CM (low nibble) must be 8 (deflate); CINFO (high nibble) must be <= 7
    # (window size up to 32 KiB).
    method = cmf & 0x0F
    cinfo = cmf >> 4
    return method == 8 and cinfo <= 7
