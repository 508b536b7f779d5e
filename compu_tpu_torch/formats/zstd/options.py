"""zstd encoder options: the port's ``ZstdOptions``, after
``compu_tpu/formats/zstd/options.py``.

The port always runs the LZ stage on the device, so it takes none of the
reference's settings that pick a host parse (``level``, ``strategy``) and
no ``device_lz`` switch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ZstdOptions:
    """Encoder options (reference: ZstdOptions, src/encoder/zstd.rs:62-133).

    ``window_log`` bounds match distances (10..31);
    ``checksum`` controls the xxhash64 content checksum (the reference
    relies on libzstd's default off; ours defaults on — flip for byte
    parity scenarios).
    """

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
        if not 10 <= self.window_log <= 31:
            raise ValueError("window_log must be in 10..31")
