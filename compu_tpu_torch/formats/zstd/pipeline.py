"""zstd encoder backend: the port's copy of ``ZstdEncoder`` from
``compu_tpu/formats/zstd/pipeline.py``, mapping the streaming Encoder
contract onto the frame codec."""

from __future__ import annotations

from ..base import EncoderBackend
from .encode import ZstdStreamEncoder
from .options import ZstdOptions


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
