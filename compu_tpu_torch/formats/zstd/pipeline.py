"""zstd backends: the port's copies of ``ZstdEncoder``, ``ZstdDecoder``,
``NativeZstdEncoder`` and ``NativeZstdDecoder`` from
``compu_tpu/formats/zstd/pipeline.py``, mapping the streaming Encoder and
Decoder contracts onto the frame codec: the device-LZ encoder and the
Python decoder, and the host runtime's standalone encoder and decoder."""

from __future__ import annotations

from ..base import DecoderBackend, EncoderBackend
from .decode import ERRORS, ZstdFrameDecoder
from .encode import MAX_BLOCK, ZstdStreamEncoder
from .options import ZstdDecodeOptions, ZstdOptions


class ZstdEncoder(EncoderBackend):
    """Stages ``tokenizer_span`` bytes (8 frame blocks) per device
    tokenizer call, as the reference's device-LZ encoder does; each call's
    cover is sliced into frame blocks of at most 128 KiB. ``device`` runs
    the device stages (CUDA by default)."""

    name = "zstd"

    def __init__(self, options: ZstdOptions | None = None, device=None) -> None:
        self.options = options or ZstdOptions()
        super().__init__()
        self._stream = ZstdStreamEncoder(
            checksum=self.options.checksum,
            window_log=self.options.window_log,
            device_literals=self.options.device_literals,
            device_sequences=self.options.device_sequences,
            device=device,
        )
        self.block_size = self._stream.tokenizer_span

    def _header(self) -> bytes:
        return self._stream.header()

    def _compress(self, data: bytes, final: bool) -> bytes:
        return self._stream.compress_chunk(data, final)

    def _trailer(self) -> bytes:
        return self._stream.trailer()

    def _do_reset(self) -> None:
        self._stream.reset()


class NativeZstdEncoder(ZstdEncoder):
    """Same format, the host runtime's standalone encoder
    (``native_enc2.NativeZstdStream``), by ``options.level``,
    ``window_log`` and ``checksum``: a second complete zstd encoder behind
    the same interface. It does no device work."""

    name = "zstd-native"
    block_size = MAX_BLOCK

    def __init__(self, options: ZstdOptions | None = None) -> None:
        from .native_enc2 import NativeZstdStream

        self.options = options or ZstdOptions()
        EncoderBackend.__init__(self)
        self._stream = NativeZstdStream(
            level=self.options.level,
            window_log=self.options.window_log,
            checksum=self.options.checksum,
        )

    def _header(self) -> bytes:
        return b""  # the frame header rides in the first compress_chunk

    def _trailer(self) -> bytes:
        return b""  # the closing block and checksum ride the final chunk


class ZstdDecoder(DecoderBackend):
    """Frames through ``ZstdFrameDecoder``; with ``device_literals`` its
    4-stream literal sections decode on ``device`` (CUDA by default)."""

    name = "zstd"
    ERRORS = ERRORS

    def __init__(self, options: ZstdDecodeOptions | None = None, device=None) -> None:
        self.options = options or ZstdDecodeOptions()
        self.device = device
        super().__init__()
        self._frame = self._new_frame()

    def _new_frame(self) -> ZstdFrameDecoder:
        frame = ZstdFrameDecoder(window_log_max=self.options.window_log_max,
                                 device_literals=self.options.device_literals,
                                 device=self.device)
        frame.sink_budget = self.pending_high_water
        return frame

    def _pump(self) -> None:
        consumed, finished = self._frame.pump(self._staged, self._staged_pos)
        if self._frame.sink:
            self._pending.extend(self._frame.sink)
            self._frame.sink = bytearray()
        self._staged_pos = consumed
        if finished:
            self._finished = True

    def _rebase_input(self, nbytes: int) -> None:
        self._frame.pos -= nbytes

    def _do_reset(self) -> None:
        self._frame = self._new_frame()


class NativeZstdDecoder(ZstdDecoder):
    """Same format, the host runtime's frame decoder
    (``native_decode.NativeZstdFrame``: entropy tables, sequences, window
    and xxh64 all in C++). It reads ``options.window_log_max`` and does no
    device work."""

    name = "zstd-native"

    def __init__(self, options: ZstdDecodeOptions | None = None) -> None:
        self.options = options or ZstdDecodeOptions()
        DecoderBackend.__init__(self)
        self._frame = self._new_frame()

    def _new_frame(self):
        from .native_decode import NativeZstdFrame

        frame = NativeZstdFrame(window_log_max=self.options.window_log_max)
        frame.sink_budget = self.pending_high_water
        return frame

    def _do_reset(self) -> None:
        self._frame._reset_stream()
        self._frame.sink_budget = self.pending_high_water
