"""Trivial "stored" codec: length-prefixed raw chunks with an adler32
trailer. The port's copy of ``compu_tpu/formats/stored.py``: it proves
the streaming state machine (statuses, ops, chunk resume, reset) without
any compression.

Wire format (CTS1):
    header : b"CTS1"
    chunk  : tag u8 (0 = chunk, 1 = final chunk, 2 = flush mark)
             len u32 LE, then len raw bytes (tag 2 has len 0)
    trailer: adler32 of the whole decoded payload, u32 LE
"""

from __future__ import annotations

import struct

from ..ops.checksum import adler32
from .base import CodecFailure, DecoderBackend, EncoderBackend

MAGIC = b"CTS1"

ERR_MAGIC = 1
ERR_TAG = 2
ERR_CHECKSUM = 3
ERR_TRUNCATED = 4

_ERRORS = {
    ERR_MAGIC: "invalid stored-stream magic",
    ERR_TAG: "invalid chunk tag",
    ERR_CHECKSUM: "checksum mismatch",
    ERR_TRUNCATED: "stream truncated after final chunk",
}


class StoredEncoder(EncoderBackend):
    name = "stored"
    block_size = 1 << 20

    def __init__(self) -> None:
        super().__init__()
        self._adler = 1

    def _header(self) -> bytes:
        return MAGIC

    def _compress(self, data: bytes, final: bool) -> bytes:
        self._adler = adler32(data, self._adler)
        tag = 1 if final else 0
        return struct.pack("<BI", tag, len(data)) + data

    def _flush_mark(self) -> bytes:
        return struct.pack("<BI", 2, 0)

    def _trailer(self) -> bytes:
        return struct.pack("<I", self._adler)

    def _do_reset(self) -> None:
        self._adler = 1


class StoredDecoder(DecoderBackend):
    name = "stored"
    ERRORS = _ERRORS

    def __init__(self) -> None:
        super().__init__()
        self._saw_header = False
        self._saw_final = False
        self._adler = 1

    def _pump(self) -> None:
        buf = self._staged
        pos = self._staged_pos
        if not self._saw_header:
            if len(buf) - pos < 4:
                return
            if bytes(buf[pos : pos + 4]) != MAGIC:
                raise CodecFailure(ERR_MAGIC, _ERRORS[ERR_MAGIC])
            pos += 4
            self._saw_header = True
        while not self._saw_final:
            if len(buf) - pos < 5:
                break
            tag, length = struct.unpack_from("<BI", buf, pos)
            if tag not in (0, 1, 2):
                raise CodecFailure(ERR_TAG, _ERRORS[ERR_TAG])
            if len(buf) - pos < 5 + length:
                break
            payload = bytes(buf[pos + 5 : pos + 5 + length])
            pos += 5 + length
            if length:
                self._adler = adler32(payload, self._adler)
                self._pending.extend(payload)
            if tag == 1:
                self._saw_final = True
        if self._saw_final and not self._finished:
            if len(buf) - pos >= 4:
                (expect,) = struct.unpack_from("<I", buf, pos)
                pos += 4
                if expect != self._adler:
                    raise CodecFailure(ERR_CHECKSUM, _ERRORS[ERR_CHECKSUM])
                self._finished = True
        self._staged_pos = pos

    def _do_reset(self) -> None:
        self._saw_header = False
        self._saw_final = False
        self._adler = 1
