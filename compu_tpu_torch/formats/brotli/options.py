"""Brotli options: the port's ``BrotliMode`` and ``BrotliOptions``, after
``compu_tpu/formats/brotli/options.py``.

The port always runs the LZ stage on the device, so its options have no
``device_lz`` switch, as its ``ZstdOptions`` has none.
"""

from __future__ import annotations

import dataclasses
import enum


class BrotliMode(enum.Enum):
    """Input hint. It drives the literal context model: ``Text`` enables
    the UTF8 context map from quality 2, ``Font`` disables it (font data
    wants the signed context mode, which the encoder does not model), and
    ``Generic`` enables it from quality 5."""

    Generic = 0
    Text = 1
    Font = 2


@dataclasses.dataclass(frozen=True)
class BrotliOptions:
    """Encoder options: quality 1-11, the input mode and the window's
    log2 size (10-24)."""

    quality: int = 9
    mode: BrotliMode = BrotliMode.Generic
    window_bits: int = 22

    def __post_init__(self) -> None:
        if not 1 <= self.quality <= 11:
            raise ValueError("brotli quality must be in 1..11")
        if not 10 <= self.window_bits <= 24:
            raise ValueError("window_bits must be in 10..24")
