"""DEFLATE encoder backend on the port's device path.

Port of ``DeflateEncoder`` (framing), ``_DeviceDeflateStream`` and
``DeviceDeflateEncoder`` from ``compu_tpu/formats/deflate/pipeline.py``.
The framing emits zlib (RFC1950), gzip (RFC1952) or raw streams with
rolling adler32/crc32 (the standard library's, which give zlib's values).
The deflate core is the device: every pipeline block is one
``encode_block_dyn`` call, a self-contained raw-deflate run ending in a
sync flush, so block outputs concatenate into one standard stream.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..base import EncoderBackend
from .options import ZlibMode, ZlibOptions, stream_header

# level -> min(depth of the reference's v1 level ladder, 8): the depth the
# reference's device stream passes to encode_block_dyn.
_STREAM_DEPTH = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8, 9: 8}


class _DeviceDeflateStream:
    """Deflate core on the device. Like the reference's, it calls
    ``encode_block_dyn`` with depth ``_STREAM_DEPTH[level]`` and the
    kernel's defaults (wcap 32, two sort keys, stride 1)."""

    def __init__(self, level: int, block_size: int, device) -> None:
        self.level = level
        self.block_size = block_size
        self.device = torch.device(device)

    def compress(self, chunk: bytes, final: bool) -> bytes:
        out = b""
        if chunk:
            from ...kernels.deflate_v3 import encode_block_dyn

            depth = _STREAM_DEPTH[max(1, min(9, self.level))]
            arr = np.zeros(self.block_size, dtype=np.uint8)
            arr[: len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            blob, meta = encode_block_dyn(
                torch.from_numpy(arr).to(self.device), len(chunk), depth=depth)
            nbytes = int(meta[0])
            out = blob[:nbytes].cpu().numpy().tobytes()
        if final:
            out += bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])  # final empty stored block
        return out


class DeviceDeflateEncoder(EncoderBackend):
    """Device-backed deflate/zlib/gzip encoder behind the streaming state
    machine. Matches never cross a pipeline block (the window resets per
    block), so every block is decodable on its own. ``device`` defaults to
    CUDA. Every device block ends byte-aligned at a sync flush, so Flush
    and the trailer add no deflate bytes of their own."""

    name = "zlib-device"
    block_size = 1 << 18  # one encode_block_dyn call per block

    def __init__(self, options: ZlibOptions | None = None, block_size: int | None = None,
                 device=None) -> None:
        self.options = options or ZlibOptions()
        if block_size is not None:
            self.block_size = block_size
        super().__init__()
        self._stream = _DeviceDeflateStream(
            self.options.level, self.block_size, "cuda" if device is None else device)
        self._init_checksums()

    def _init_checksums(self) -> None:
        self._adler = 1
        self._crc = 0
        self._isize = 0

    def _header(self) -> bytes:
        return stream_header(self.options.mode, self.options.level)

    def _compress(self, data: bytes, final: bool) -> bytes:
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            self._adler = zlib.adler32(data, self._adler)
        elif mode is ZlibMode.Gzip:
            self._crc = zlib.crc32(data, self._crc)
            self._isize += len(data)
        return self._stream.compress(data, final)

    def _trailer(self) -> bytes:
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            return struct.pack(">I", self._adler)
        if mode is ZlibMode.Gzip:
            return struct.pack("<II", self._crc, self._isize & 0xFFFFFFFF)
        return b""

    def _do_reset(self) -> None:
        self._init_checksums()
