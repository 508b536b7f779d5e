"""The resumable host DEFLATE decoder (inflate) with zlib/gzip/raw
framing: the port's copy of ``compu_tpu/formats/deflate/inflate.py``, and
the ``ERR_*`` codes and ``ERRORS`` table every DEFLATE decoder of the port
reports through ``describe_error``.

``Inflate`` consumes as much staged input as there is, suspends anywhere
mid-stream (``NeedMoreBits``) and resumes at the last whole token,
verifies the adler32/crc32 trailer, and rejects a corrupt stream with a
typed error code. It accepts any foreign stream bit for bit, decoding a
token at a time through flat Huffman tables: the plain version of the
host runtime's decoder (``native_inflate.py``) and of the device's
(``device_inflate.py``).
"""

from __future__ import annotations

import numpy as np

from ...ops import checksum
from ...ops.bitio import BitReader, NeedMoreBits
from ...ops.huffman import build_decode_table
from ..base import CodecFailure
from . import consts
from .options import ZlibMode

# Error codes (surfaced through DecodeError; messages in ERRORS).
ERR_HEADER = 101
ERR_BLOCK_TYPE = 102
ERR_STORED_LEN = 103
ERR_CODE_LENGTHS = 104
ERR_BAD_SYMBOL = 105
ERR_DISTANCE = 106
ERR_CHECKSUM = 107
ERR_DICT_REQUIRED = 108
ERR_LENGTH_MISMATCH = 109
ERR_TRAILING = 110

ERRORS = {
    ERR_HEADER: "invalid stream header",
    ERR_BLOCK_TYPE: "invalid deflate block type",
    ERR_STORED_LEN: "stored block LEN/NLEN mismatch",
    ERR_CODE_LENGTHS: "invalid huffman code lengths",
    ERR_BAD_SYMBOL: "invalid huffman symbol",
    ERR_DISTANCE: "distance too far back",
    ERR_CHECKSUM: "stream checksum mismatch",
    ERR_DICT_REQUIRED: "preset dictionary not supported",
    ERR_LENGTH_MISMATCH: "gzip length field mismatch",
    ERR_TRAILING: "truncated trailer",
}

_FIXED_LIT_TABLE = None
_FIXED_DIST_TABLE = None


def _fixed_tables():
    global _FIXED_LIT_TABLE, _FIXED_DIST_TABLE
    if _FIXED_LIT_TABLE is None:
        _FIXED_LIT_TABLE = build_decode_table(consts.FIXED_LITLEN_LENGTHS, 9)
        _FIXED_DIST_TABLE = build_decode_table(consts.FIXED_DIST_LENGTHS, 5)
    return _FIXED_LIT_TABLE, _FIXED_DIST_TABLE


class Inflate:
    """Streaming inflate state machine over an external staged buffer.

    ``pump(staged, pos)`` decodes as far as possible, returning
    ``(new_pos, finished)`` and appending output via ``self.sink``
    (a bytearray). Raises CodecFailure on corruption.
    """

    def __init__(self, mode: ZlibMode = ZlibMode.Auto) -> None:
        self.mode = mode
        self.sink = bytearray()
        self._reset_stream()

    def _reset_stream(self) -> None:
        self.phase = "frame_header"
        self.bitpos = 0
        self.framing = None  # resolved concrete framing: 'zlib'|'gzip'|'raw'
        self.final_block = False
        self.block_phase = None
        self.lit_table = None
        self.dist_table = None
        self.lit_bits = 0
        self.dist_bits = 0
        self.stored_remaining = 0
        self.window = bytearray()  # last 32 KiB of decoded output
        #: Pause decoding once this many undrained sink bytes exist
        #: (back-pressure; None = unbounded).
        self.sink_budget = None
        self.adler = 1
        self.crc = 0
        self.out_count = 0
        self.gzip_flags = 0

    # ------------------------------------------------------------------
    def _emit(self, data) -> None:
        self.sink.extend(data)
        self.window.extend(data)
        if len(self.window) > consts.WINDOW_SIZE:
            del self.window[: len(self.window) - consts.WINDOW_SIZE]
        if self.framing == "zlib":
            self.adler = checksum.adler32(data, self.adler)
        elif self.framing == "gzip":
            self.crc = checksum.crc32(data, self.crc)
        self.out_count += len(data)

    # ------------------------------------------------------------------
    def pump(self, staged, pos: int) -> tuple[int, bool]:
        """Decode from ``staged[pos:]``; returns (bytes consumed up to a
        resumable point, finished)."""
        del pos  # absolute resume state lives in self.bitpos
        reader = BitReader(staged, self.bitpos)
        try:
            while True:
                if self.phase == "frame_header":
                    self._parse_frame_header(reader, staged)
                elif self.phase == "block_header":
                    self._parse_block_header(reader)
                elif self.phase == "stored":
                    self._pump_stored(reader)
                elif self.phase == "tokens":
                    self._pump_tokens(reader)
                elif self.phase == "frame_trailer":
                    self._parse_trailer(reader)
                elif self.phase == "done":
                    return reader.bitpos // 8, True
        except NeedMoreBits:
            self.bitpos = reader.bitpos
            return reader.bitpos // 8, False

    # ------------------------------------------------------------------
    def _parse_frame_header(self, reader: BitReader, staged) -> None:
        """The zlib or gzip header, whole or not at all: a header cut short
        leaves the reader where it began, so that the next call parses it
        from its first byte. (The reference's keeps the bytes it read, and
        loses the header's place when a zlib header, or a gzip header's
        optional fields, arrive in more than one call.)"""
        start = reader.bitpos
        try:
            self._parse_frame_header_fields(reader, staged)
        except NeedMoreBits:
            reader.bitpos = start
            raise

    def _parse_frame_header_fields(self, reader: BitReader, staged) -> None:
        mode = self.mode
        if mode is ZlibMode.Auto:
            if reader.remaining_bits() < 16:
                raise NeedMoreBits()
            b0 = staged[reader.bitpos // 8]
            b1 = staged[reader.bitpos // 8 + 1]
            if b0 == 0x1F and b1 == 0x8B:
                mode = ZlibMode.Gzip
            elif ((b0 << 8) | b1) % 31 == 0 and (b0 & 0x0F) == 8 and (b0 >> 4) <= 7:
                mode = ZlibMode.Zlib
            else:
                raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])

        if mode is ZlibMode.Deflate:
            self.framing = "raw"
        elif mode is ZlibMode.Zlib:
            cmf = reader.read(8)
            flg = reader.read(8)
            if ((cmf << 8) | flg) % 31 != 0 or (cmf & 0x0F) != 8 or (cmf >> 4) > 7:
                raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
            if flg & 0x20:
                raise CodecFailure(ERR_DICT_REQUIRED, ERRORS[ERR_DICT_REQUIRED])
            self.framing = "zlib"
        elif mode is ZlibMode.Gzip:
            self._parse_gzip_header(reader)
            self.framing = "gzip"
        else:  # pragma: no cover
            raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
        self.bitpos = reader.bitpos
        self.phase = "block_header"

    def _parse_gzip_header(self, reader: BitReader) -> None:
        if reader.remaining_bits() < 80:
            raise NeedMoreBits()
        magic0 = reader.read(8)
        magic1 = reader.read(8)
        method = reader.read(8)
        flags = reader.read(8)
        reader.read(32)  # mtime
        reader.read(8)  # xfl
        reader.read(8)  # os
        if magic0 != 0x1F or magic1 != 0x8B or method != 8 or flags & 0xE0:
            raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
        if flags & 0x04:  # FEXTRA
            xlen = reader.read(16)
            for _ in range(xlen):
                reader.read(8)
        if flags & 0x08:  # FNAME: zero-terminated
            while reader.read(8) != 0:
                pass
        if flags & 0x10:  # FCOMMENT
            while reader.read(8) != 0:
                pass
        if flags & 0x02:  # FHCRC
            reader.read(16)

    # ------------------------------------------------------------------
    def _parse_block_header(self, reader: BitReader) -> None:
        start = reader.bitpos
        try:
            bfinal = reader.read(1)
            btype = reader.read(2)
            if btype == 0:
                reader.align_byte()
                length = reader.read(16)
                nlen = reader.read(16)
                if length != (~nlen & 0xFFFF):
                    raise CodecFailure(ERR_STORED_LEN, ERRORS[ERR_STORED_LEN])
                self.stored_remaining = length
                self.phase = "stored"
            elif btype == 1:
                (lit_syms, lit_lens), (dist_syms, dist_lens) = (
                    _fixed_tables()[0],
                    _fixed_tables()[1],
                )
                self.lit_table = (lit_syms, lit_lens)
                self.dist_table = (dist_syms, dist_lens)
                self.lit_bits = 9
                self.dist_bits = 5
                self.phase = "tokens"
            elif btype == 2:
                self._parse_dynamic_header(reader)
                self.phase = "tokens"
            else:
                raise CodecFailure(ERR_BLOCK_TYPE, ERRORS[ERR_BLOCK_TYPE])
            self.final_block = bool(bfinal)
            self.bitpos = reader.bitpos
        except NeedMoreBits:
            reader.bitpos = start
            self.bitpos = start
            raise

    def _parse_dynamic_header(self, reader: BitReader) -> None:
        hlit = reader.read(5) + 257
        hdist = reader.read(5) + 1
        hclen = reader.read(4) + 4
        clen_lengths = np.zeros(19, dtype=np.int64)
        for i in range(hclen):
            clen_lengths[consts.CLEN_ORDER[i]] = reader.read(3)
        if clen_lengths.max() == 0:
            raise CodecFailure(ERR_CODE_LENGTHS, ERRORS[ERR_CODE_LENGTHS])
        cl_syms, cl_lens = build_decode_table(clen_lengths, 7)
        # Decode hlit+hdist code lengths with the code-length code.
        lengths = np.zeros(hlit + hdist, dtype=np.int64)
        i = 0
        while i < hlit + hdist:
            idx = reader.peek(7)
            l = int(cl_lens[idx])
            if l == 0 or reader.remaining_bits() < l:
                if reader.remaining_bits() < 7 and l == 0:
                    raise NeedMoreBits()
                if l == 0:
                    raise CodecFailure(ERR_CODE_LENGTHS, ERRORS[ERR_CODE_LENGTHS])
                raise NeedMoreBits()
            sym = int(cl_syms[idx])
            reader.skip(l)
            if sym < 16:
                lengths[i] = sym
                i += 1
            elif sym == 16:
                if i == 0:
                    raise CodecFailure(ERR_CODE_LENGTHS, ERRORS[ERR_CODE_LENGTHS])
                rep = 3 + reader.read(2)
                lengths[i : i + rep] = lengths[i - 1]
                i += rep
            elif sym == 17:
                i += 3 + reader.read(3)
            else:  # 18
                i += 11 + reader.read(7)
        if i > hlit + hdist:
            raise CodecFailure(ERR_CODE_LENGTHS, ERRORS[ERR_CODE_LENGTHS])
        lit_lengths = lengths[:hlit]
        dist_lengths = lengths[hlit:]
        if lit_lengths[256] == 0:
            raise CodecFailure(ERR_CODE_LENGTHS, ERRORS[ERR_CODE_LENGTHS])
        self.lit_bits = int(lit_lengths.max())
        self.lit_table = build_decode_table(lit_lengths, self.lit_bits)
        self.dist_bits = max(int(dist_lengths.max()), 1)
        self.dist_table = build_decode_table(dist_lengths, self.dist_bits)

    # ------------------------------------------------------------------
    def _pump_stored(self, reader: BitReader) -> None:
        # Byte-aligned raw copy; may span multiple pumps.
        while self.stored_remaining > 0:
            avail_bytes = reader.remaining_bits() // 8
            if avail_bytes == 0:
                raise NeedMoreBits()
            take = min(self.stored_remaining, avail_bytes)
            start = reader.bitpos // 8
            self._emit(bytes(reader.data[start : start + take]))
            reader.bitpos += take * 8
            self.stored_remaining -= take
            self.bitpos = reader.bitpos
        self._end_block()

    def _end_block(self) -> None:
        if self.final_block:
            self.phase = "frame_trailer"
        else:
            self.phase = "block_header"

    def _pump_tokens(self, reader: BitReader) -> None:
        lit_syms, lit_lens = self.lit_table
        dist_syms, dist_lens = self.dist_table
        lit_bits = self.lit_bits
        dist_bits = self.dist_bits
        window = self.window
        out = bytearray()
        lb = consts.LENGTH_BASE
        le = consts.LENGTH_EXTRA
        db = consts.DIST_BASE
        de = consts.DIST_EXTRA
        checkpoint = reader.bitpos
        try:
            while True:
                idx = reader.peek(lit_bits)
                l = int(lit_lens[idx])
                if l == 0:
                    if reader.remaining_bits() < lit_bits:
                        raise NeedMoreBits()
                    raise CodecFailure(ERR_BAD_SYMBOL, ERRORS[ERR_BAD_SYMBOL])
                if reader.remaining_bits() < l:
                    raise NeedMoreBits()
                sym = int(lit_syms[idx])
                reader.skip(l)
                if sym < 256:
                    out.append(sym)
                    window.append(sym)
                    if len(out) >= 65536:
                        self._flush_tokens(out, reader)
                        out = bytearray()
                        if (self.sink_budget is not None
                                and len(self.sink) >= self.sink_budget):
                            # Output budget reached: pause at this token
                            # boundary (resumable exactly like input
                            # starvation — bitpos is committed).
                            checkpoint = reader.bitpos
                            raise NeedMoreBits()
                    checkpoint = reader.bitpos
                    continue
                if sym == 256:
                    self._flush_tokens(out, reader)
                    out = bytearray()
                    self._end_block()
                    return
                code = sym - 257
                if code >= 29:
                    raise CodecFailure(ERR_BAD_SYMBOL, ERRORS[ERR_BAD_SYMBOL])
                length = int(lb[code]) + reader.read(int(le[code]))
                didx = reader.peek(dist_bits)
                dl = int(dist_lens[didx])
                if dl == 0:
                    if reader.remaining_bits() < dist_bits:
                        raise NeedMoreBits()
                    raise CodecFailure(ERR_BAD_SYMBOL, ERRORS[ERR_BAD_SYMBOL])
                if reader.remaining_bits() < dl:
                    raise NeedMoreBits()
                dsym = int(dist_syms[didx])
                reader.skip(dl)
                if dsym >= 30:
                    raise CodecFailure(ERR_BAD_SYMBOL, ERRORS[ERR_BAD_SYMBOL])
                dist = int(db[dsym]) + reader.read(int(de[dsym]))
                if dist > len(window):
                    raise CodecFailure(ERR_DISTANCE, ERRORS[ERR_DISTANCE])
                # Copy match from the sliding window (overlap = repetition).
                start = len(window) - dist
                if dist >= length:
                    piece = window[start : start + length]
                else:
                    piece = bytes(window[start:])
                    reps = -(-length // dist)
                    piece = (piece * reps)[:length]
                out.extend(piece)
                window.extend(piece)
                if len(window) > 4 * consts.WINDOW_SIZE:
                    del window[: len(window) - consts.WINDOW_SIZE]
                if len(out) >= 65536:
                    self._flush_tokens(out, reader)
                    out = bytearray()
                    if (self.sink_budget is not None
                            and len(self.sink) >= self.sink_budget):
                        checkpoint = reader.bitpos
                        raise NeedMoreBits()
                checkpoint = reader.bitpos
        except NeedMoreBits:
            # Roll back to the last complete token, keep decoded output.
            reader.bitpos = checkpoint
            self._flush_tokens(out, reader)
            raise

    def _flush_tokens(self, out: bytearray, reader: BitReader) -> None:
        """Commit decoded bytes (checksums + sink) and the bit position.

        The window was maintained incrementally; only trim it here."""
        if out:
            self.sink.extend(out)
            if self.framing == "zlib":
                self.adler = checksum.adler32(out, self.adler)
            elif self.framing == "gzip":
                self.crc = checksum.crc32(out, self.crc)
            self.out_count += len(out)
        if len(self.window) > consts.WINDOW_SIZE:
            del self.window[: len(self.window) - consts.WINDOW_SIZE]
        self.bitpos = reader.bitpos

    # ------------------------------------------------------------------
    def _parse_trailer(self, reader: BitReader) -> None:
        reader.align_byte()
        if self.framing == "zlib":
            if reader.remaining_bits() < 32:
                self.bitpos = reader.bitpos
                raise NeedMoreBits()
            expect = 0
            for _ in range(4):  # big-endian
                expect = (expect << 8) | reader.read(8)
            if expect != self.adler:
                raise CodecFailure(ERR_CHECKSUM, ERRORS[ERR_CHECKSUM])
        elif self.framing == "gzip":
            if reader.remaining_bits() < 64:
                self.bitpos = reader.bitpos
                raise NeedMoreBits()
            crc = reader.read(32)
            isize = reader.read(32)
            if crc != self.crc:
                raise CodecFailure(ERR_CHECKSUM, ERRORS[ERR_CHECKSUM])
            if isize != (self.out_count & 0xFFFFFFFF):
                raise CodecFailure(ERR_LENGTH_MISMATCH, ERRORS[ERR_LENGTH_MISMATCH])
        self.bitpos = reader.bitpos
        self.phase = "done"
