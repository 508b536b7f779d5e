"""Brotli options: the port's ``BrotliMode`` and ``BrotliOptions``, after
``compu_tpu/formats/brotli/options.py``.

The port runs the LZ stage on the device unless asked not to
(``device_lz=False``); the reference's default is its host match finder.
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
    """Encoder options: quality 1-11, the input mode, the window's log2
    size (10-24), and where the LZ stage runs."""

    quality: int = 9
    mode: BrotliMode = BrotliMode.Generic
    window_bits: int = 22
    #: Run the LZ match+parse stage on the device (``formats/device_lz.py``,
    #: kernels B1 and B2); ``False`` takes the host match finder and parse
    #: by quality. The reference's default is ``False``.
    device_lz: bool = True

    def __post_init__(self) -> None:
        if not 1 <= self.quality <= 11:
            raise ValueError("brotli quality must be in 1..11")
        if not 10 <= self.window_bits <= 24:
            raise ValueError("window_bits must be in 10..24")
