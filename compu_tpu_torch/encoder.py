"""The streaming encoder over the port's backends.

The port's copy of ``compu_tpu/encoder.py::Encoder``: the 3-op protocol
(Process/Flush/Finish) and its convenience layer (``encode_vec``,
``encode_vec_full``, ``encode_buf``). ``Interface`` is a registry of
pipeline factories with the port's constructors: ``stored``; the host
backends ``zlib``, ``zlib_native``, ``zstd_native`` and ``brotli_native``,
which take no ``device``; and ``zlib_device``, ``zstd`` and ``brotli``
over the device. ``ByteVec`` and the status types are re-exported so a
caller names only this module.
"""

from __future__ import annotations

from typing import Callable, Dict

from .formats.base import EncoderBackend
from .status import Encode, EncodeOp, EncodeStatus
from .vec import ByteVec

__all__ = ["ByteVec", "Encode", "EncodeOp", "EncodeStatus", "Encoder", "Interface"]


class Encoder:
    """Owns one encode pipeline and drives it through the op/status contract."""

    __slots__ = ("_backend",)

    def __init__(self, backend: EncoderBackend) -> None:
        self._backend = backend

    @property
    def name(self) -> str:
        return self._backend.name

    def encode(self, inp, out, op: EncodeOp) -> Encode:
        """Encode ``inp`` into the writable buffer ``out`` under ``op``.
        Only the provided buffer is written."""
        return self._backend.encode(inp, out, op)

    def encode_vec(self, inp, vec: ByteVec, op: EncodeOp) -> Encode:
        """Encode into ``vec``'s spare capacity, advancing its length."""
        spare = vec.spare_capacity_mut()
        result = self.encode(inp, spare, op)
        vec.add_len(len(spare) - result.output_remain)
        return result

    def encode_vec_full(self, inp, vec: ByteVec, op: EncodeOp) -> Encode:
        """Encode a complete input, growing ``vec`` as needed: the first
        reservation is a fraction of the input, since compression usually
        shrinks it."""
        size = len(inp)
        if size < 1024:
            vec.reserve_exact(max(64, size + 64))
        elif size < 65_536:
            vec.reserve_exact(size // 2 + 128)
        else:
            vec.reserve_exact(size // 3 + 256)
        inp = memoryview(inp)
        while True:
            result = self.encode_vec(inp, vec, op)
            if result.status is not EncodeStatus.NeedOutput:
                return result
            inp = inp[len(inp) - result.input_remain :]
            vec.reserve_exact(1024 if len(vec) < 65_536 else 8192)

    def encode_buf(self, inp, out_buf, op: EncodeOp) -> Encode:
        """Encode into a growable sink. Sinks exposing
        ``chunk_mut()``/``advance_mut()`` (``ChunkedSink``) are written in
        place, chunk by chunk; plain ``bytearray`` sinks get each 64 KiB
        chunk appended."""
        inp = memoryview(inp)
        lending = hasattr(out_buf, "chunk_mut") and hasattr(out_buf, "advance_mut")
        staged = None if lending else bytearray(65_536)
        while True:
            chunk = out_buf.chunk_mut() if lending else staged
            result = self.encode(inp, chunk, op)
            produced = len(chunk) - result.output_remain
            if lending:
                out_buf.advance_mut(produced)
            else:
                out_buf.extend(chunk[:produced])
            if result.status is not EncodeStatus.NeedOutput:
                return Encode(result.input_remain, result.output_remain, result.status)
            inp = inp[len(inp) - result.input_remain :]

    def reset(self) -> bool:
        """Re-arm for a new stream, keeping the construction options."""
        return self._backend.reset()


class Interface:
    """Registry of encode pipeline factories, and the port's constructors."""

    _registry: Dict[str, Callable[..., EncoderBackend]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[..., EncoderBackend]) -> None:
        cls._registry[name] = factory

    @classmethod
    def new(cls, name: str, *args, **kwargs) -> Encoder:
        try:
            factory = cls._registry[name]
        except KeyError:
            raise ValueError(f"unknown encoder backend: {name!r}") from None
        return Encoder(factory(*args, **kwargs))

    @staticmethod
    def stored() -> Encoder:
        """The length-prefixed raw chunk format with an adler32 trailer,
        which proves the state machine without compression."""
        from .formats import stored

        return Encoder(stored.StoredEncoder())

    @staticmethod
    def zlib(options=None) -> Encoder:
        """DEFLATE (zlib/gzip/raw framing by ``options.mode``, a
        ``ZlibOptions``) on the host: ``deflate_encode.DeflateStream``, its
        match finder and cover in the host runtime above 4 KiB."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.DeflateEncoder(options))

    @staticmethod
    def zlib_native(options=None) -> Encoder:
        """The same format from the host runtime's C++ deflate core
        (``runtime/csrc/compu_deflate.cpp``); level 0 runs the Python
        core. Raises if the runtime cannot be built."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.NativeDeflateEncoder(options))

    @staticmethod
    def zlib_device(options=None, block_size=None, device=None) -> Encoder:
        """DEFLATE (zlib/gzip/raw framing by ``options.mode``) with every
        256 KiB pipeline block encoded on ``device`` (CUDA by default)."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.DeviceDeflateEncoder(
            options, block_size=block_size, device=device))

    @staticmethod
    def zstd(options=None, device=None) -> Encoder:
        """Zstandard frames. ``options`` is a ``ZstdOptions``: by default
        (``device_lz=True``) the LZ stage runs on ``device`` (CUDA by
        default); ``device_lz=False`` takes the reference's host match
        finders and parse by ``level`` and ``strategy``, which touch no
        device. ``device_literals`` and ``device_sequences`` move the
        literal streams and the sequences bitstream to the device too."""
        from .formats.zstd import pipeline

        return Encoder(pipeline.ZstdEncoder(options, device=device))

    @staticmethod
    def zstd_native(options=None) -> Encoder:
        """Zstandard frames from the host runtime's standalone C++ encoder
        (``runtime/csrc/compu_zstd_enc2.cpp``: hash-chain matcher, repeat
        offsets, FSE sequence modes, 1/4-stream Huffman literals,
        streaming xxh64), by ``options.level``, ``window_log`` and
        ``checksum``. Raises if the runtime cannot be built."""
        from .formats.zstd import pipeline

        return Encoder(pipeline.NativeZstdEncoder(options))

    @staticmethod
    def brotli_native(options=None) -> Encoder:
        """Brotli streams from the host runtime's standalone C++ encoder
        (``runtime/csrc/compu_brotli_enc2.cpp``), by ``options.quality``
        and ``window_bits``. Raises if the runtime cannot be built."""
        from .formats.brotli import pipeline

        return Encoder(pipeline.NativeBrotliEncoder(options))

    @staticmethod
    def brotli(options=None, device=None) -> Encoder:
        """Brotli streams. ``options`` is a ``BrotliOptions`` (quality,
        mode, window_bits, device_lz); each 1 MiB pipeline block is one
        meta-block, its prefix codes and bits written on the host. By
        default (``device_lz=True``) its LZ tokens come from one tokenizer
        call on ``device`` (CUDA by default); ``device_lz=False`` takes the
        reference's host match finder and parse by quality, and touches no
        device."""
        from .formats.brotli import pipeline

        return Encoder(pipeline.BrotliEncoder(options, device=device))
