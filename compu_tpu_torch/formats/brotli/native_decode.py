"""The host runtime's streaming brotli decode: the meta-block state
machine runs in C++ (``runtime/csrc/compu_brotli.cpp``); this wrapper
adapts it to the pump/sink protocol ``DecoderBackend`` drives. The port's
copy of ``compu_tpu/formats/brotli/native_decode.py``: a second brotli
decoder behind ``decoder.Interface.brotli_native``, with ``decode.py``'s
as its plain version.

The spec's data (the static dictionary, the context table and the word
transforms of RFC 7932's appendices, the port's own ``dictionary.bin``,
``context_table.bin`` and ``transforms_data.py``) are handed to the
library once a process (``compu_brotli_set_tables``).
"""

from __future__ import annotations

import ctypes
import threading

from ...runtime import native
from ..base import CodecFailure
from .decode import ERRORS

_NEED_INPUT, _NEED_OUTPUT, _DONE = 0, 1, 2
# C++ codes -1..-8 map onto decode.py's ERR_STREAM..ERR_WINDOW (401..408)
_CPP_ERR_BASE = 400

_tables_lock = threading.Lock()
_tables_sent = False

_TYPE_IDS = {
    "identity": 0,
    "omit_first": 1,
    "omit_last": 2,
    "ferment_first": 3,
    "ferment_all": 4,
}


def _pack_transforms() -> bytes:
    from .transforms_data import TRANSFORMS

    out = bytearray()
    for prefix, tname, k, suffix in TRANSFORMS:
        out.append(_TYPE_IDS[tname])
        out.append(k)
        out.append(len(prefix))
        out.append(len(suffix))
        out.extend(prefix)
        out.extend(suffix)
    return bytes(out)


def _ensure_tables(lib) -> None:
    global _tables_sent
    with _tables_lock:
        if _tables_sent:
            return
        from . import consts as C

        ctx = bytes(C.CONTEXT_TABLE.tobytes())
        tr = _pack_transforms()
        lib.compu_brotli_set_tables(
            C.DICTIONARY, len(C.DICTIONARY), ctx, len(ctx), tr, len(tr))
        _tables_sent = True


class NativeBrotliState:
    """Drop-in for :class:`BrotliDecoderState` (same pump/sink/sink_budget
    protocol); meta-block decoding delegated to the host runtime.

    ``self.bitpos`` tracks the absolute BIT position into the staged buffer
    (like the Python state), so the backend's byte-based compaction hook
    can rebase it."""

    SCRATCH = 1 << 20

    def __init__(self) -> None:
        self._lib = native.lib()
        _ensure_tables(self._lib)
        self.sink = bytearray()
        self.sink_budget = None
        self.bitpos = 0
        self.done = False
        self._handle = self._lib.compu_brotli_new()
        self._scratch = ctypes.create_string_buffer(self.SCRATCH)

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_brotli_free(h)
            self._handle = None

    def _reset_stream(self) -> None:
        self.bitpos = 0
        self.done = False
        self.sink = bytearray()
        self._lib.compu_brotli_reset(self._handle)

    def pump(self, staged, pos: int) -> tuple[int, bool]:
        del pos
        while True:
            if (self.sink_budget is not None
                    and len(self.sink) >= self.sink_budget):
                return self.bitpos // 8, self.done
            start = self.bitpos // 8
            # The C++ state holds the sub-byte remainder; feed from the
            # containing byte, a bounded copy of the staged input at a time.
            remaining = min(len(staged) - start, 4 * self.SCRATCH)
            view = bytes(memoryview(staged)[start:start + remaining])
            arr = (ctypes.c_ubyte * remaining).from_buffer_copy(view) \
                if remaining else (ctypes.c_ubyte * 0)()
            consumed = ctypes.c_size_t(0)
            written = ctypes.c_size_t(0)
            st = self._lib.compu_brotli_run(
                self._handle,
                ctypes.cast(arr, ctypes.POINTER(ctypes.c_ubyte)),
                remaining, 0,
                self._scratch, self.SCRATCH,
                ctypes.byref(consumed), ctypes.byref(written),
            )
            if written.value:
                self.sink.extend(self._scratch.raw[: written.value])
            self.bitpos = (start + consumed.value) * 8
            if st < 0:
                code = _CPP_ERR_BASE - st
                raise CodecFailure(code, ERRORS.get(code, "corrupt stream"))
            if st == _DONE:
                self.done = True
                return self.bitpos // 8, True
            if st == _NEED_OUTPUT:
                continue  # scratch drained into sink; run again
            if remaining < len(staged) - start and consumed.value:
                continue  # NEED_INPUT from the bounded copy, not the stream
            return self.bitpos // 8, False
