"""Brotli backends: the port's copies of ``BrotliEncoder``,
``BrotliDecoder``, ``NativeBrotliEncoder`` and ``NativeBrotliDecoder``
from ``compu_tpu/formats/brotli/pipeline.py``: the device-LZ encoder and
the Python decoder, and the host runtime's standalone encoder and decoder.
They buffer internally; the stream header rides in the first meta-block's bits
and the final empty meta-block ends the stream, so there are no header or
trailer bytes of their own, and a flush adds no marker (the bits past the
last whole byte wait in the encoder)."""

from __future__ import annotations

from ..base import DecoderBackend, EncoderBackend
from .decode import ERRORS, BrotliDecoderState
from .encode import TOKENIZER_SPAN, BrotliStreamEncoder
from .options import BrotliOptions


class BrotliEncoder(EncoderBackend):
    """One meta-block, and one device tokenizer call, a pipeline block of
    1 MiB. ``device`` runs the LZ stage (CUDA by default)."""

    name = "brotli"
    block_size = TOKENIZER_SPAN

    def __init__(self, options: BrotliOptions | None = None, device=None) -> None:
        self.options = options or BrotliOptions()
        super().__init__()
        self._stream = BrotliStreamEncoder(
            quality=self.options.quality,
            window_bits=self.options.window_bits,
            mode=self.options.mode,
            device=device,
        )

    def _compress(self, data: bytes, final: bool) -> bytes:
        return self._stream.compress_chunk(data, final)

    def _do_reset(self) -> None:
        self._stream.reset()


class NativeBrotliEncoder(BrotliEncoder):
    """Same format, the host runtime's standalone encoder
    (``native_enc2.NativeBrotliStream``), by ``options.quality`` and
    ``window_bits``: a second complete brotli encoder behind the same
    interface. It does no device work."""

    name = "brotli-native"
    block_size = 1 << 20  # one meta-block per pipeline block

    def __init__(self, options: BrotliOptions | None = None) -> None:
        from .native_enc2 import NativeBrotliStream

        self.options = options or BrotliOptions()
        EncoderBackend.__init__(self)
        self._stream = NativeBrotliStream(
            quality=self.options.quality,
            window_bits=self.options.window_bits,
        )


class BrotliDecoder(DecoderBackend):
    """Any brotli stream through ``BrotliDecoderState``, on the host."""

    name = "brotli"
    ERRORS = ERRORS

    def __init__(self, options=None) -> None:
        del options  # the decoder takes no options, as the reference's
        super().__init__()
        self._state = BrotliDecoderState()
        self._state.sink_budget = self.pending_high_water

    def _pump(self) -> None:
        consumed, finished = self._state.pump(self._staged, self._staged_pos)
        if self._state.sink:
            self._pending.extend(self._state.sink)
            self._state.sink = bytearray()
        self._staged_pos = consumed
        if finished:
            self._finished = True

    def _rebase_input(self, nbytes: int) -> None:
        self._state.bitpos -= 8 * nbytes

    def _do_reset(self) -> None:
        self._state = BrotliDecoderState()
        self._state.sink_budget = self.pending_high_water


class NativeBrotliDecoder(BrotliDecoder):
    """Same format, the host runtime's meta-block decoder
    (``native_decode.NativeBrotliState``: prefix codes, context maps,
    block switching and dictionary transforms all in C++). It does no
    device work."""

    name = "brotli-native"

    def __init__(self, options=None) -> None:
        from .native_decode import NativeBrotliState

        del options
        DecoderBackend.__init__(self)
        self._state = NativeBrotliState()
        self._state.sink_budget = self.pending_high_water

    def _do_reset(self) -> None:
        self._state._reset_stream()
        self._state.sink_budget = self.pending_high_water
