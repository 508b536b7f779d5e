"""zstd options: the port's ``ZstdStrategy``, ``ZstdOptions`` and
``ZstdDecodeOptions``, after ``compu_tpu/formats/zstd/options.py``.

Two defaults differ from the reference's, so that the port's entry points
run on the device unless the caller asks for the host: ``Interface.zstd``
runs the LZ stage on the device (``device_lz=True``; the reference's
default is its host match finder and parse), and the decoder decodes the
4-stream literal sections there (``device_literals=True``).
"""

from __future__ import annotations

import dataclasses
import enum


class ZstdStrategy(enum.Enum):
    """Compression strategy ladder (reference: src/encoder/zstd.rs:35-56).

    A non-default strategy *overrides* the parse effort the level implies
    (libzstd's ``ZSTD_c_strategy`` semantics, applied by the reference at
    src/encoder/zstd.rs:121): Fast/DFast/Greedy select the greedy chain
    walk at increasing depth, Lazy/Lazy2 the lazy heuristic, BtLazy2 a deep
    lazy walk, and BtOpt/BtUltra/BtUltra2 the cost-model optimal parse at
    increasing depth/candidate budgets. The level keeps governing entropy
    and window behavior. The device LZ stage reads neither."""

    Default = 0
    Fast = 1
    DFast = 2
    Greedy = 3
    Lazy = 4
    Lazy2 = 5
    BtLazy2 = 6
    BtOpt = 7
    BtUltra = 8
    BtUltra2 = 9


@dataclasses.dataclass(frozen=True)
class ZstdOptions:
    """Encoder options (reference: ZstdOptions, src/encoder/zstd.rs:62-133).

    ``level`` follows zstd's ladder: 1..22 standard levels, 0 means the
    default (3), and negative levels down to -131072 select the fast path
    (all negative levels share the fastest rung). It sets the host route's
    parse (``device_lz=False``), which ``strategy`` overrides, and the
    effort of ``Interface.zstd_native``; the device LZ stage reads neither.
    ``window_log`` bounds match distances (10..31);
    ``checksum`` controls the xxhash64 content checksum (the reference
    relies on libzstd's default off; ours defaults on — flip for byte
    parity scenarios).
    """

    level: int = 3
    strategy: ZstdStrategy = ZstdStrategy.Default
    window_log: int = 17
    checksum: bool = True
    #: Run the LZ match+parse stage on the device (``formats/device_lz.py``,
    #: kernels B1 and B2); ``False`` takes the host match finder and parse.
    #: The reference's default is ``False``.
    device_lz: bool = True
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
