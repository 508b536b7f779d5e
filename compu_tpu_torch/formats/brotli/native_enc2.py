"""The host runtime's standalone brotli encoder
(``runtime/csrc/compu_brotli_enc2.cpp``: hash-chain matcher, command
planning, prefix codes and header), the port's copy of
``compu_tpu/formats/brotli/native_enc2.py``: a second complete brotli
encoder behind ``encoder.Interface.brotli_native``.
"""

from __future__ import annotations

import ctypes

from ...runtime import native
from ..base import CodecFailure


class NativeBrotliStream:
    """One stream: one meta-block per compress_chunk call; the distance
    ring, window history and bit phase carry across calls in C++."""

    def __init__(self, quality: int = 9, window_bits: int = 22) -> None:
        self._lib = native.lib()
        self.quality = quality
        self.window_bits = window_bits
        self._handle = self._lib.compu_brenc2_new(quality, window_bits)
        if not self._handle:
            raise RuntimeError("brotli encoder init failed")

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_brenc2_free(h)
            self._handle = None

    def reset(self) -> None:
        self._lib.compu_brenc2_reset(self._handle)

    def compress_chunk(self, data: bytes, final: bool) -> bytes:
        cap = max(len(data), 1) * 2 + (1 << 16)
        out = ctypes.create_string_buffer(cap)
        w = self._lib.compu_brenc2_run(self._handle, bytes(data), len(data), out, cap,
                                       1 if final else 0)
        if w < 0:
            raise CodecFailure(401, "brotli encode overflow")
        return out.raw[:w]
