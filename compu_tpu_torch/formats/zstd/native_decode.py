"""The host runtime's streaming zstd decode: the whole frame state machine
runs in C++ (``runtime/csrc/compu_zstd.cpp``); this wrapper adapts it to
the pump/sink protocol ``DecoderBackend`` drives. The port's copy of
``compu_tpu/formats/zstd/native_decode.py``: a second zstd decoder behind
``decoder.Interface.zstd_native``, with ``decode.py``'s as its plain
version.
"""

from __future__ import annotations

import ctypes

from ...runtime import native
from ..base import CodecFailure
from .decode import ERRORS

_NEED_INPUT, _NEED_OUTPUT, _DONE = 0, 1, 2
# C++ codes -1..-9 map onto decode.py's ERR_MAGIC..ERR_DICT (201..209)
_CPP_ERR_BASE = 200


class NativeZstdFrame:
    """Drop-in for :class:`ZstdFrameDecoder` (same pump/sink/sink_budget
    protocol); frame decoding delegated to the host runtime."""

    SCRATCH = 1 << 20  # output burst of one run

    def __init__(self, window_log_max: int = 31) -> None:
        self._lib = native.lib()
        self.window_log_max = window_log_max
        self.sink = bytearray()
        self.sink_budget = None
        self.pos = 0
        self._handle = self._lib.compu_zstd_new(window_log_max)
        self._scratch = ctypes.create_string_buffer(self.SCRATCH)

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_zstd_free(h)
            self._handle = None

    def _reset_stream(self) -> None:
        self.pos = 0
        self.sink = bytearray()
        self._lib.compu_zstd_reset(self._handle)

    def pump(self, staged, pos: int) -> tuple[int, bool]:
        del pos
        while True:
            if self.sink_budget is not None and len(self.sink) >= self.sink_budget:
                return self.pos, False
            # A bounded copy of the staged input: O(n) copying in all, and
            # a NEED_INPUT at the copy's end resumes from the stream.
            remaining = min(len(staged) - self.pos, 2 * self.SCRATCH)
            view = bytes(memoryview(staged)[self.pos:self.pos + remaining])
            arr = (ctypes.c_ubyte * remaining).from_buffer_copy(view) \
                if remaining else (ctypes.c_ubyte * 0)()
            consumed = ctypes.c_size_t(0)
            written = ctypes.c_size_t(0)
            st = self._lib.compu_zstd_run(
                self._handle,
                ctypes.cast(arr, ctypes.POINTER(ctypes.c_ubyte)),
                remaining,
                self._scratch, self.SCRATCH,
                ctypes.byref(consumed), ctypes.byref(written),
            )
            if written.value:
                self.sink.extend(self._scratch.raw[: written.value])
            self.pos += consumed.value
            if st < 0:
                code = _CPP_ERR_BASE - st
                raise CodecFailure(code, ERRORS.get(code, "corrupt stream"))
            if st == _DONE:
                return self.pos, True
            if st == _NEED_OUTPUT:
                continue  # scratch drained into sink; run again
            if remaining < len(staged) - self.pos + consumed.value and consumed.value:
                continue  # NEED_INPUT from the bounded copy, not the stream
            return self.pos, False
