"""The host runtime's standalone zstd encoder
(``runtime/csrc/compu_zstd_enc2.cpp``: hash-chain matcher, repeat offsets,
RLE/custom/predefined sequence modes, 1/4-stream Huffman literals,
streaming xxh64), the port's copy of
``compu_tpu/formats/zstd/native_enc2.py``: a second complete zstd encoder
behind ``encoder.Interface.zstd_native``.
"""

from __future__ import annotations

import ctypes

from ...runtime import native
from ..base import CodecFailure


class NativeZstdStream:
    """One frame: blocks per compress_chunk call; window history, repeat
    offsets and the content checksum carry across calls in C++."""

    def __init__(self, level: int = 3, window_log: int = 21,
                 checksum: bool = True) -> None:
        self._lib = native.lib()
        self._handle = self._lib.compu_zstd2_new(level, window_log, 1 if checksum else 0)
        if not self._handle:
            raise RuntimeError("zstd encoder init failed")

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_zstd2_free(h)
            self._handle = None

    def reset(self) -> None:
        self._lib.compu_zstd2_reset(self._handle)

    def compress_chunk(self, data: bytes, final: bool) -> bytes:
        """Frame blocks of ``data``; the frame header rides in the first
        call's output, the closing block and checksum in the final one's."""
        cap = max(len(data), 1) * 2 + (1 << 16)
        out = ctypes.create_string_buffer(cap)
        w = self._lib.compu_zstd2_run(self._handle, bytes(data), len(data), out, cap,
                                      1 if final else 0)
        if w < 0:
            raise CodecFailure(301, "zstd encode overflow")
        return out.raw[:w]
