"""zstd options: the port's ``ZstdOptions`` and ``ZstdDecodeOptions``,
after ``compu_tpu/formats/zstd/options.py``.

The port's ``Interface.zstd`` always runs the LZ stage on the device, so
it takes none of the reference's settings that pick a host parse
(``strategy``) and no ``device_lz`` switch; ``level`` is read by the host
runtime's encoder (``Interface.zstd_native``) alone. The decoder decodes
the 4-stream literal sections on the device unless asked not to (the
reference's default is the host).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ZstdOptions:
    """Encoder options (reference: ZstdOptions, src/encoder/zstd.rs:62-133).

    ``level`` follows zstd's ladder (1..22, 0 the default 3, negative
    levels down to -131072 the fast path) and sets the effort of
    ``Interface.zstd_native``; the device-LZ encode does not read it.
    ``window_log`` bounds match distances (10..31);
    ``checksum`` controls the xxhash64 content checksum (the reference
    relies on libzstd's default off; ours defaults on — flip for byte
    parity scenarios).
    """

    level: int = 3
    window_log: int = 17
    checksum: bool = True
    #: Encode the 4-stream Huffman literals section on the device
    #: (byte-identical output; kernels/zstd_literals.py).
    device_literals: bool = False
    #: Encode the FSE sequence bitstream on the device (byte-identical
    #: output; kernels/zstd_seq.py) — with device_literals this completes
    #: the device zstd block-entropy path.
    device_sequences: bool = False

    def __post_init__(self) -> None:
        if not -131072 <= self.level <= 22:  # ZSTD_minCLevel()..ZSTD_maxCLevel()
            raise ValueError("zstd level must be in -131072..22")
        if not 10 <= self.window_log <= 31:
            raise ValueError("window_log must be in 10..31")


@dataclasses.dataclass(frozen=True)
class ZstdDecodeOptions:
    """Decoder options (reference: src/decoder/zstd.rs:22-74): the
    window_log cap; ``device_literals`` decodes the 4-stream Huffman
    literal sections on the device (kernel P2, kernels/zstd_lit_decode.py),
    and ``False`` on the host (``HufTable.decode_stream``, whose over-read
    limit is 32 bits where P2's route takes 64, as the reference's)."""

    window_log_max: int = 31
    device_literals: bool = True

    def __post_init__(self) -> None:
        if not 10 <= self.window_log_max <= 31:
            raise ValueError("window_log_max must be in 10..31")
