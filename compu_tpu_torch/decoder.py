"""The streaming decoder over the port's format backends.

The port's copy of ``compu_tpu/decoder.py``: ``Decoder`` owns one decode
pipeline and exposes the raw layer (``decode``) and the convenience layer
(``decode_vec``, ``decode_vec_full``, ``decode_buf``); ``Interface`` is a
registry of pipeline factories with the port's constructors: ``stored``;
``zlib`` and ``zlib_native`` (any deflate, zlib or gzip stream, inflated
on the host by ``Inflate`` or the host runtime), ``zlib_device`` (the same,
inflated on the device); ``zstd`` and ``zstd_native``; ``brotli`` and
``brotli_native``. ``ByteVec`` and the status types are re-exported so a
caller names only this module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .formats.base import DecoderBackend
from .status import Decode, DecodeError, DecodeStatus
from .vec import ByteVec

__all__ = ["ByteVec", "Decode", "DecodeError", "DecodeStatus", "Decoder", "Interface"]


class Decoder:
    """Owns one decode pipeline and drives it through the status contract."""

    __slots__ = ("_backend",)

    def __init__(self, backend: DecoderBackend) -> None:
        self._backend = backend

    @property
    def name(self) -> str:
        return self._backend.name

    # -- raw layer -----------------------------------------------------------
    def decode(self, inp, out) -> Decode:
        """Decode ``inp`` into the writable buffer ``out``.

        Never allocates output: only the provided buffer is written.
        Returns byte counts left in each buffer plus the status.
        """
        return self._backend.decode(inp, out)

    # -- convenience layer ---------------------------------------------------
    def decode_vec(self, inp, vec: ByteVec) -> Decode:
        """Decode into ``vec``'s spare capacity, advancing its length."""
        spare = vec.spare_capacity_mut()
        result = self.decode(inp, spare)
        vec.add_len(len(spare) - result.output_remain)
        return result

    def decode_vec_full(self, inp, vec: ByteVec) -> Decode:
        """Decode a complete stream, growing ``vec`` as needed: the first
        reservation grows with the input in size tiers, later ones are
        1 KiB below 64 KiB of output and 8 KiB above."""
        size = len(inp)
        if size < 1024:
            vec.reserve_exact(size if size > 0 else 64)
        elif size < 16_384:
            vec.reserve_exact(size + size // 3)
        elif size < 65_536:
            vec.reserve_exact(size + size // 2)
        else:
            vec.reserve_exact(2 * size)
        inp = memoryview(inp)
        while True:
            result = self.decode_vec(inp, vec)
            if result.is_error or result.status is not DecodeStatus.NeedOutput:
                return result
            inp = inp[len(inp) - result.input_remain :]
            vec.reserve_exact(1024 if len(vec) < 65_536 else 8192)

    def decode_buf(self, inp, out_buf) -> Decode:
        """Decode into a growable sink. Sinks exposing
        ``chunk_mut()``/``advance_mut()`` are written in place, chunk by
        chunk; plain ``bytearray`` sinks get each 64 KiB chunk appended."""
        inp = memoryview(inp)
        lending = hasattr(out_buf, "chunk_mut") and hasattr(out_buf, "advance_mut")
        staged = None if lending else bytearray(65_536)
        while True:
            chunk = out_buf.chunk_mut() if lending else staged
            result = self.decode(inp, chunk)
            produced = len(chunk) - result.output_remain
            if lending:
                out_buf.advance_mut(produced)
            else:
                out_buf.extend(chunk[:produced])
            if result.is_error or result.status is not DecodeStatus.NeedOutput:
                return Decode(result.input_remain, result.output_remain, result.status)
            inp = inp[len(inp) - result.input_remain :]

    def reset(self) -> bool:
        """Re-arm for a new stream without losing options."""
        return self._backend.reset()

    def describe_error(self, error) -> Optional[str]:
        code = error.code if isinstance(error, DecodeError) else int(error)
        return self._backend.describe_error(code)


class Interface:
    """Registry of decode pipeline factories, and the port's constructors."""

    _registry: Dict[str, Callable[..., DecoderBackend]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[..., DecoderBackend]) -> None:
        cls._registry[name] = factory

    @classmethod
    def new(cls, name: str, *args, **kwargs) -> Decoder:
        try:
            factory = cls._registry[name]
        except KeyError:
            raise ValueError(f"unknown decoder backend: {name!r}") from None
        return Decoder(factory(*args, **kwargs))

    # -- convenience constructors -------------------------------------------
    @staticmethod
    def stored() -> Decoder:
        """The stored format of ``encoder.Interface.stored``."""
        from .formats import stored

        return Decoder(stored.StoredDecoder())

    @staticmethod
    def zlib(options=None) -> Decoder:
        """Deflate, zlib or gzip streams from any encoder, inflated on the
        host by ``Inflate`` a token at a time (the decoder does no device
        work, so it takes no ``device``). ``options`` is a
        ``ZlibDecodeOptions`` or a ``ZlibMode`` (default ``Auto``)."""
        from .formats.deflate import pipeline

        return Decoder(pipeline.DeflateDecoder(options))

    @staticmethod
    def zlib_native(options=None) -> Decoder:
        """The same streams through the host runtime's C++ inflate
        (``runtime/csrc/compu_inflate.cpp``), framing and trailer in
        Python. Raises if the runtime cannot be built."""
        from .formats.deflate import pipeline

        return Decoder(pipeline.NativeDeflateDecoder(options))

    @staticmethod
    def zlib_device(options=None, device=None) -> Decoder:
        """Deflate, zlib or gzip streams from any encoder, inflated on
        ``device`` (CUDA unless the caller passes ``"cpu"``, which runs the
        kernels' plain versions): the 48-phase speculative chunk scan, one
        launch of kernel P4 a wave, and the stream-global back-reference
        resolution. ``options`` is a ``ZlibDecodeOptions`` or a
        ``ZlibMode`` (default ``Auto``, which sniffs the framing); see
        ``formats/deflate/device_inflate.py``."""
        from .formats.deflate import device_inflate

        return Decoder(device_inflate.DeviceDeflateDecoder(options, device=device))

    @staticmethod
    def zstd(options=None, device=None) -> Decoder:
        """Zstandard frames. ``options`` is a ``ZstdDecodeOptions``; by
        default (its ``device_literals``) the 4-stream literal sections
        decode on ``device`` (CUDA unless the caller passes ``"cpu"``, which
        runs the kernel's plain version), the rest on the host."""
        from .formats.zstd import pipeline

        return Decoder(pipeline.ZstdDecoder(options, device=device))

    @staticmethod
    def zstd_native(options=None) -> Decoder:
        """Zstandard frames through the host runtime's C++ frame decoder
        (``runtime/csrc/compu_zstd.cpp``: entropy tables, sequences,
        window and xxh64). ``options`` is a ``ZstdDecodeOptions``, of which
        it reads ``window_log_max``. Raises if the runtime cannot be
        built."""
        from .formats.zstd import pipeline

        return Decoder(pipeline.NativeZstdDecoder(options))

    @staticmethod
    def brotli_native(options=None) -> Decoder:
        """Brotli streams through the host runtime's C++ meta-block decoder
        (``runtime/csrc/compu_brotli.cpp``), given the port's dictionary,
        context table and transforms. ``options`` is ignored. Raises if
        the runtime cannot be built."""
        from .formats.brotli import pipeline

        return Decoder(pipeline.NativeBrotliDecoder(options))

    @staticmethod
    def brotli(options=None) -> Decoder:
        """Any brotli stream, decoded on the host (the reference's decoder
        does no device work, so this one takes no ``device``). ``options``
        is accepted and ignored, as the reference's."""
        from .formats.brotli import pipeline

        return Decoder(pipeline.BrotliDecoder(options))
