"""The host runtime's streaming inflate: framing and trailer in Python, the
raw-deflate state machine in C++ (``runtime/csrc/compu_inflate.cpp``,
which also folds the framing's checksum over its output in the same pass).
The port's copy of ``compu_tpu/formats/deflate/native_inflate.py``: a
second implementation of the format behind the same decoder interface,
with ``Inflate`` (``inflate.py``) as its plain version.
"""

from __future__ import annotations

import ctypes
import struct

from ...runtime import native
from ..base import CodecFailure
from .inflate import (
    ERR_CHECKSUM,
    ERR_HEADER,
    ERR_LENGTH_MISMATCH,
    ERRORS,
)
from .options import ZlibMode

# Status codes of compu_inflate_run
_NEED_INPUT, _NEED_OUTPUT, _DONE = 0, 1, 2
_CPP_ERRORS = {-1: 102, -2: 103, -3: 104, -4: 105, -5: 106}


class NativeInflate:
    """Drop-in for :class:`Inflate` (same pump/sink/sink_budget protocol),
    raw-deflate decoding delegated to the host runtime's state machine."""

    SCRATCH = 4 << 20  # per-run native output burst

    def __init__(self, mode: ZlibMode = ZlibMode.Auto) -> None:
        self._lib = native.lib()
        self.mode = mode
        self.sink = bytearray()
        self._handle = self._lib.compu_inflate_new()
        self._scratch = ctypes.create_string_buffer(self.SCRATCH)
        self._reset_stream()

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_inflate_free(h)
            self._handle = None

    def _reset_stream(self) -> None:
        self.phase = "frame_header"
        self.pos = 0  # absolute byte offset into the staged buffer
        self.framing = None
        self.sink_budget = None
        self.adler = 1
        self.crc = 0
        self.out_count = 0
        self._lib.compu_inflate_reset(self._handle)
        self._lib.compu_inflate_set_check(self._handle, 0)

    # -- framing ------------------------------------------------------------
    def _parse_frame_header(self, staged) -> bool:
        """Returns True when the header is complete; False = need input."""
        mode = self.mode
        avail = len(staged) - self.pos
        if mode is ZlibMode.Auto:
            if avail < 2:
                return False
            b0, b1 = staged[self.pos], staged[self.pos + 1]
            if b0 == 0x1F and b1 == 0x8B:
                mode = ZlibMode.Gzip
            elif ((b0 << 8) | b1) % 31 == 0 and (b0 & 0x0F) == 8 and (b0 >> 4) <= 7:
                mode = ZlibMode.Zlib
            else:
                raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
        if mode is ZlibMode.Deflate:
            self.framing = "raw"
            return True
        if mode is ZlibMode.Zlib:
            if avail < 2:
                return False
            cmf, flg = staged[self.pos], staged[self.pos + 1]
            if ((cmf << 8) | flg) % 31 != 0 or (cmf & 0x0F) != 8 or (cmf >> 4) > 7:
                raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
            if flg & 0x20:
                raise CodecFailure(108, ERRORS[108])
            self.pos += 2
            self.framing = "zlib"
            return True
        # gzip
        if avail < 10:
            return False
        p = self.pos
        magic0, magic1, method, flags = staged[p], staged[p + 1], staged[p + 2], staged[p + 3]
        if magic0 != 0x1F or magic1 != 0x8B or method != 8 or flags & 0xE0:
            raise CodecFailure(ERR_HEADER, ERRORS[ERR_HEADER])
        p += 10
        if flags & 0x04:  # FEXTRA
            if len(staged) - p < 2:
                return False
            xlen = staged[p] | (staged[p + 1] << 8)
            if len(staged) - p < 2 + xlen:
                return False
            p += 2 + xlen
        for bit in (0x08, 0x10):  # FNAME, FCOMMENT: NUL-terminated
            if flags & bit:
                end = staged.find(b"\x00", p) if hasattr(staged, "find") else bytes(staged).find(b"\x00", p)
                if end < 0:
                    return False
                p = end + 1
        if flags & 0x02:  # FHCRC
            if len(staged) - p < 2:
                return False
            p += 2
        self.pos = p
        self.framing = "gzip"
        return True

    # -- main pump ------------------------------------------------------------
    def pump(self, staged, pos: int):
        del pos
        while True:
            if self.phase == "frame_header":
                if not self._parse_frame_header(staged):
                    return self.pos, False
                self.phase = "deflate"
                self._lib.compu_inflate_set_check(
                    self._handle, {"zlib": 1, "gzip": 2}.get(self.framing, 0))
            if self.phase == "deflate":
                if (self.sink_budget is not None
                        and len(self.sink) >= self.sink_budget):
                    return self.pos, False
                # ONE input copy per pump call (a zero-copy from_buffer view
                # would pin the bytearray against the backend's compaction:
                # ctypes releases exports only at gc time, not on del); all
                # NEED_OUTPUT bursts drain against this same copy with the
                # consumed offset advancing, so bytes are copied once, not
                # once per burst.
                remaining = len(staged) - self.pos
                arr = ((ctypes.c_ubyte * remaining).from_buffer_copy(
                    memoryview(staged)[self.pos:]) if remaining
                    else (ctypes.c_ubyte * 0)())
                off = 0
                consumed = ctypes.c_size_t(0)
                written = ctypes.c_size_t(0)
                while True:
                    st = self._lib.compu_inflate_run(
                        self._handle,
                        ctypes.cast(ctypes.byref(arr, off),
                                    ctypes.POINTER(ctypes.c_ubyte)),
                        remaining - off,
                        self._scratch, self.SCRATCH,
                        ctypes.byref(consumed), ctypes.byref(written),
                    )
                    if written.value:
                        self.sink.extend(
                            memoryview(self._scratch)[: written.value])
                        self.out_count += written.value
                    off += consumed.value
                    self.pos += consumed.value
                    if st == _NEED_OUTPUT:
                        continue  # scratch drained into sink; run again
                    break
                if st < 0:
                    code = _CPP_ERRORS.get(st, 105)
                    raise CodecFailure(code, ERRORS.get(code, "corrupt stream"))
                if st == _DONE:
                    chk = self._lib.compu_inflate_get_check(self._handle)
                    if self.framing == "zlib":
                        self.adler = chk
                    elif self.framing == "gzip":
                        self.crc = chk
                    self.phase = "trailer"
                    continue
                return self.pos, False  # NEED_INPUT
            if self.phase == "trailer":
                took = self._check_trailer(staged, self.pos)
                if took is None:
                    return self.pos, False
                self.pos += took
                self.phase = "done"
            if self.phase == "done":
                return self.pos, True

    def _check_trailer(self, buf, off: int):
        """Verify the frame trailer at ``buf[off:]``. Returns the trailer
        byte count, or None when more input is needed; raises CodecFailure
        on checksum/length mismatch."""
        avail = len(buf) - off
        if self.framing == "zlib":
            if avail < 4:
                return None
            (want,) = struct.unpack_from(">I", bytes(buf[off:off + 4]))
            if want != self.adler & 0xFFFFFFFF:
                raise CodecFailure(ERR_CHECKSUM, ERRORS[ERR_CHECKSUM])
            return 4
        if self.framing == "gzip":
            if avail < 8:
                return None
            want_crc, want_len = struct.unpack_from(
                "<II", bytes(buf[off:off + 8]))
            if want_crc != self.crc & 0xFFFFFFFF:
                raise CodecFailure(ERR_CHECKSUM, ERRORS[ERR_CHECKSUM])
            if want_len != self.out_count & 0xFFFFFFFF:
                raise CodecFailure(
                    ERR_LENGTH_MISMATCH, ERRORS[ERR_LENGTH_MISMATCH])
            return 8
        return 0  # raw deflate: no trailer

    # -- zero-copy direct path -------------------------------------------------
    def run_direct(self, inp, out):
        """One-call fast path: decode straight from the caller's input view
        into the caller's output view, with no staging, scratch or sink.
        Returns (consumed, written, finished, need_output), or None when
        the stream is done or its header is not whole yet (the staged path
        then buffers it). C++ keeps the bit-level token state, so calls
        chain: NEED_OUTPUT leaves the tail unconsumed for a re-feed."""
        import numpy as _np

        if self.phase == "done":
            return None
        off = 0
        if self.phase == "frame_header":
            self.pos = 0
            if not self._parse_frame_header(inp):
                return None  # partial header: let the staged path buffer it
            off = self.pos
            self.pos = 0
            self.phase = "deflate"
            self._lib.compu_inflate_set_check(
                self._handle, {"zlib": 1, "gzip": 2}.get(self.framing, 0))
        written = 0
        need_output = False
        if self.phase == "deflate":
            n_in = len(inp) - off
            in_arr = _np.frombuffer(inp, dtype=_np.uint8) if len(inp) else None
            out_arr = (_np.frombuffer(out, dtype=_np.uint8) if len(out)
                       else None)
            in_ptr = (in_arr.__array_interface__["data"][0] + off
                      if in_arr is not None else 0)
            out_ptr = (out_arr.__array_interface__["data"][0]
                       if out_arr is not None else 0)
            consumed = ctypes.c_size_t(0)
            got = ctypes.c_size_t(0)
            st = self._lib.compu_inflate_run(
                self._handle,
                ctypes.cast(ctypes.c_void_p(in_ptr),
                            ctypes.POINTER(ctypes.c_ubyte)),
                n_in,
                ctypes.c_void_p(out_ptr), len(out),
                ctypes.byref(consumed), ctypes.byref(got),
            )
            del in_arr, out_arr
            off += consumed.value
            written = got.value
            self.out_count += written
            if st < 0:
                code = _CPP_ERRORS.get(st, 105)
                raise CodecFailure(code, ERRORS.get(code, "corrupt stream"))
            if st == _DONE:
                chk = self._lib.compu_inflate_get_check(self._handle)
                if self.framing == "zlib":
                    self.adler = chk
                elif self.framing == "gzip":
                    self.crc = chk
                self.phase = "trailer"
            elif st == _NEED_OUTPUT:
                need_output = True
        if self.phase == "trailer":
            took = self._check_trailer(inp, off)
            if took is not None:
                off += took
                self.phase = "done"
                return off, written, True, False
        return off, written, self.phase == "done", need_output
