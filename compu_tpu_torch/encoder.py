"""The streaming encoder over the port's device backend.

The port's copy of ``compu_tpu/encoder.py::Encoder``: the 3-op protocol
(Process/Flush/Finish) and its convenience layer (``encode_vec``,
``encode_vec_full``). ``Interface`` holds the port's only
constructor, ``zlib_device``. ``ByteVec`` and the status types are
re-exported so a caller names only this module.
"""

from __future__ import annotations

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

    def reset(self) -> bool:
        """Re-arm for a new stream, keeping the construction options."""
        return self._backend.reset()


class Interface:
    """Constructors of the port's encoders."""

    @staticmethod
    def zlib_device(options=None, block_size=None, device=None) -> Encoder:
        """DEFLATE (zlib/gzip/raw framing by ``options.mode``) with every
        256 KiB pipeline block encoded on ``device`` (CUDA by default)."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.DeviceDeflateEncoder(
            options, block_size=block_size, device=device))
