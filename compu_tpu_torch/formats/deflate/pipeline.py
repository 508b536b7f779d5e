"""DEFLATE backends: the port's copy of
``compu_tpu/formats/deflate/pipeline.py``.

``DeflateEncoder`` maps the streaming Encoder contract onto a deflate core
and writes the zlib (RFC1950), gzip (RFC1952) or raw framing with a
rolling adler32/crc32. Three cores share that framing: the host's
``DeflateStream`` (``Interface.zlib``), the host runtime's C++ deflate
(``_NativeDeflateStream``, ``Interface.zlib_native``) and the device's
block encode (``_DeviceDeflateStream``, ``Interface.zlib_device``).
``DeflateDecoder`` inflates any deflate, zlib or gzip stream with the
host ``Inflate``, and ``NativeDeflateDecoder`` with the host runtime's.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from ...ops import checksum
from ...runtime import native
from ...status import DecodeStatus
from ..base import DecoderBackend, EncoderBackend
from .deflate_encode import DeflateStream
from .inflate import ERRORS, Inflate
from .options import ZlibDecodeOptions, ZlibMode, ZlibOptions, stream_header

# level -> min(depth of the reference's v1 level ladder, 8): the depth the
# reference's device stream passes to encode_block_dyn.
_STREAM_DEPTH = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8, 9: 8}


class DeflateEncoder(EncoderBackend):
    """Streaming deflate/zlib/gzip encoder backend on the host.

    Matches never cross the 1 MiB pipeline block (the window resets a
    block), so a stream of this encoder decodes block by block; the format
    stays RFC-compliant for any inflate.
    """

    name = "zlib"
    block_size = 1 << 20

    def __init__(self, options: ZlibOptions | None = None) -> None:
        self.options = options or ZlibOptions()
        super().__init__()
        self._stream = DeflateStream(
            self.options.level, self.options.strategy,
            mem_level=self.options.mem_level,
        )
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
            self._adler = checksum.adler32(data, self._adler)
        elif mode is ZlibMode.Gzip:
            self._crc = checksum.crc32(data, self._crc)
            self._isize += len(data)
        return self._stream.compress(data, final)

    def _flush_mark(self) -> bytes:
        return self._stream.sync_flush()

    def _trailer(self) -> bytes:
        out = bytearray(self._stream.align())
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            out.extend(struct.pack(">I", self._adler))
        elif mode is ZlibMode.Gzip:
            out.extend(struct.pack("<II", self._crc, self._isize & 0xFFFFFFFF))
        return bytes(out)

    def _do_reset(self) -> None:
        self._stream.reset()
        self._init_checksums()


class _DeviceDeflateStream:
    """Deflate core on the device. Like the reference's, it calls
    ``encode_block_dyn`` with depth ``_STREAM_DEPTH[level]`` and the
    kernel's defaults (wcap 32, two sort keys, stride 1): each pipeline
    block becomes a self-contained raw-deflate run ending in a sync flush,
    so the block outputs concatenate into one standard stream, and Flush
    and the trailer add no deflate bytes of their own."""

    def __init__(self, level: int, block_size: int, device) -> None:
        import torch

        self.level = level
        self.block_size = block_size
        self.device = torch.device(device)

    def reset(self) -> None:
        pass  # no state between blocks: the window resets a block

    def compress(self, chunk: bytes, final: bool) -> bytes:
        out = b""
        if chunk:
            import torch

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

    def sync_flush(self) -> bytes:
        return b""  # every device block already ends byte-aligned at a flush

    def align(self) -> bytes:
        return b""


class _NativeDeflateStream:
    """Deflate core in the host runtime (``compu_deflate.cpp``: hash-chain
    lazy matching, dynamic/fixed/stored blocks). Same compress/sync_flush/
    align/reset surface as ``DeflateStream``; the bit state carries across
    calls inside the C++ handle, so chunked output equals one-shot."""

    def __init__(self, level: int, mem_level: int = 8) -> None:
        self._lib = native.lib()
        self.level = max(1, min(9, level))
        self._handle = self._lib.compu_deflate_new(self.level)
        if mem_level != 8:
            self._lib.compu_deflate_set_hash_bits(self._handle, mem_level + 8)
        self._mem_level = mem_level

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_deflate_free(h)
            self._handle = None

    def reset(self) -> None:
        self._lib.compu_deflate_reset(self._handle)
        if self._mem_level != 8:
            self._lib.compu_deflate_set_hash_bits(self._handle, self._mem_level + 8)

    def _run(self, chunk: bytes, flush: int, final: int) -> bytes:
        cap = len(chunk) + len(chunk) // 2 + 4096
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.compu_deflate_run(self._handle, chunk, len(chunk), buf, cap, flush, final)
        return buf.raw[:n]

    def compress(self, chunk: bytes, final: bool) -> bytes:
        return self._run(chunk, 0, 1 if final else 0)

    def sync_flush(self) -> bytes:
        return self._run(b"", 1, 0)

    def align(self) -> bytes:
        return b""  # final=1 already byte-aligned the stream


class NativeDeflateEncoder(DeflateEncoder):
    """Same format, the host runtime's deflate core; the framing and
    checksums stay in Python. Level 0 (stored blocks only) runs the Python
    core, as the reference's does."""

    name = "zlib-native"

    def __init__(self, options: ZlibOptions | None = None) -> None:
        self.options = options or ZlibOptions()
        EncoderBackend.__init__(self)
        if self.options.level == 0:
            self._stream = DeflateStream(0, self.options.strategy)
        else:
            self._stream = _NativeDeflateStream(self.options.level, self.options.mem_level)
        self._init_checksums()


class DeviceDeflateEncoder(DeflateEncoder):
    """Device-backed deflate/zlib/gzip encoder behind the same framing and
    state machine as the host backend. ``device`` defaults to CUDA.
    Chunked equals one-shot because block boundaries depend only on
    absolute stream offsets."""

    name = "zlib-device"
    block_size = 1 << 18  # one encode_block_dyn call per block

    def __init__(self, options: ZlibOptions | None = None, block_size: int | None = None,
                 device=None) -> None:
        if block_size is not None:
            self.block_size = block_size
        super().__init__(options)
        self._stream = _DeviceDeflateStream(
            self.options.level, self.block_size, "cuda" if device is None else device)


class DeflateDecoder(DecoderBackend):
    """Streaming inflate backend accepting foreign streams bit-exactly."""

    name = "zlib"
    ERRORS = ERRORS

    def __init__(self, options: ZlibDecodeOptions | ZlibMode | None = None) -> None:
        if options is None:
            options = ZlibDecodeOptions()
        if isinstance(options, ZlibMode):
            options = ZlibDecodeOptions(mode=options)
        self.options = options
        super().__init__()
        self._inflate = Inflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water

    def _pump(self) -> None:
        consumed, finished = self._inflate.pump(self._staged, self._staged_pos)
        if self._inflate.sink:
            self._pending.extend(self._inflate.sink)
            self._inflate.sink = bytearray()
        self._staged_pos = consumed
        if finished:
            self._finished = True

    def _rebase_input(self, nbytes: int) -> None:
        # The inflate core keeps an absolute bit cursor into the staged
        # buffer; shift it when the backend drops the consumed prefix.
        self._inflate.bitpos -= 8 * nbytes

    def _do_reset(self) -> None:
        self._inflate = Inflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water


class NativeDeflateDecoder(DeflateDecoder):
    """Same format, the host runtime's inflate (``native_inflate.py``):
    framing and checksums in Python, the raw deflate blocks in
    ``compu_inflate.cpp``. With nothing staged or pending, a call streams
    the caller's bytes straight into the caller's buffer
    (``_decode_direct``)."""

    name = "zlib-native"

    def __init__(self, options: ZlibDecodeOptions | ZlibMode | None = None) -> None:
        from .native_inflate import NativeInflate

        if options is None:
            options = ZlibDecodeOptions()
        if isinstance(options, ZlibMode):
            options = ZlibDecodeOptions(mode=options)
        self.options = options
        DecoderBackend.__init__(self)
        self._inflate = NativeInflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water

    def _rebase_input(self, nbytes: int) -> None:
        self._inflate.pos -= nbytes

    def _decode_direct(self, inp, out):
        """Stream the caller's bytes through the C++ state machine into the
        caller's buffer. A partial-token tail on NeedInput is staged (and
        the core's position rebased to it), so a caller feeding chunks
        keeps the staged path's consumed-everything behaviour."""
        res = self._inflate.run_direct(inp, out)
        if res is None:
            return None
        consumed, written, finished, need_output = res
        if finished:
            self._finished = True
            self._pending = bytearray()
            self._pending_pos = 0
            return consumed, written, DecodeStatus.Finished
        if need_output:
            return consumed, written, DecodeStatus.NeedOutput
        if consumed < len(inp):  # partial token tail: stage it
            self._staged = bytearray(inp[consumed:])
            self._staged_pos = 0
            self._inflate.pos = 0
            consumed = len(inp)
        return consumed, written, DecodeStatus.NeedInput

    def _do_reset(self) -> None:
        self._inflate._reset_stream()
        self._inflate.sink_budget = self.pending_high_water
