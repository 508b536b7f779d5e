"""Block-parallel stream encoder for the port (pigz-style).

The port's copy of the encode half of ``compu_tpu/parallel/scheduler.py``.
A buffer is cut into fixed-size independent blocks, the device step
encodes them, and the host assembles ONE standard zlib/gzip stream:

* every block is a self-contained run of deflate blocks ending in an empty
  stored block (Z_SYNC_FLUSH), so block outputs are byte-aligned and
  concatenate freely;
* matches never cross block boundaries, so any block decodes from its own
  bytes;
* the per-block checksums from the device merge on the host with the
  combine algebra (``ops/checksum.py``);
* the encoder records a block index (compressed offset, raw length).

The port has no host re-encode: a failed device step, or a block whose
output is implausible, marks the blocks failed and raises, so a fault on
the card is never hidden behind a host encoder.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..formats.deflate.options import ZlibMode, stream_header
from ..ops import checksum
from ..utils.metrics import Metrics, trace_span

__all__ = ["BlockIndex", "BlockParallelEncoder", "BlockState", "BlockStatus"]


class BlockState:
    """Per-block scheduler status."""

    Ok = "ok"
    Failed = "failed"  # the device step failed; the stream aborts


@dataclasses.dataclass
class BlockStatus:
    index: int
    state: str = BlockState.Ok
    error: str | None = None


@dataclasses.dataclass
class BlockIndex:
    """Side index of a block-parallel stream (in stream order).

    ``segment_bits`` (optional) holds per-block arrays of segment bit
    offsets relative to each block's first byte, the key that makes the
    blocks segment-parallel to decode on a device."""

    raw_lengths: list[int]
    compressed_offsets: list[int]  # offset of each block's first byte
    compressed_lengths: list[int]
    segment_bits: list | None = None

    def to_bytes(self) -> bytes:
        out = bytearray(struct.pack("<I", len(self.raw_lengths)))
        for r, o, c in zip(self.raw_lengths, self.compressed_offsets, self.compressed_lengths):
            out.extend(struct.pack("<QQQ", r, o, c))
        return bytes(out)

    @staticmethod
    def from_bytes(blob: bytes) -> "BlockIndex":
        (n,) = struct.unpack_from("<I", blob, 0)
        idx = BlockIndex([], [], [])
        for i in range(n):
            r, o, c = struct.unpack_from("<QQQ", blob, 4 + 24 * i)
            idx.raw_lengths.append(r)
            idx.compressed_offsets.append(o)
            idx.compressed_lengths.append(c)
        return idx


class BlockParallelEncoder:
    """Encode a whole buffer as one standard stream of independent blocks.

    ``block_fn(blocks u8[B, N], lens i32[B]) -> (outs[B], out_lens[B],
    checks[B][, seg_index[B, S]])`` is the device step; ``checks`` are the
    blocks' adler32 (zlib) or finished crc32 (gzip). The host does framing,
    ordering and checksum combining only. ``host_fallback`` is accepted for
    the reference's signature and must stay False."""

    def __init__(self, block_fn, block_size: int = 1 << 20, mode: ZlibMode = ZlibMode.Gzip,
                 host_fallback: bool = False):
        if host_fallback:
            raise ValueError("the port has no host fallback: a device fault raises")
        self.block_fn = block_fn
        self.block_size = block_size
        self.mode = mode
        #: Per-block statuses of the last encode() (BlockStatus list).
        self.block_statuses: list[BlockStatus] = []
        self.metrics = Metrics()

    def encode(self, data: bytes) -> tuple[bytes, BlockIndex]:
        n = len(data)
        bs = self.block_size
        nblocks = max(1, -(-n // bs))
        with self.metrics.stage("stage_blocks"):
            blocks = np.zeros((nblocks, bs), dtype=np.uint8)
            lens = np.zeros(nblocks, dtype=np.int32)
            for i in range(nblocks):
                chunk = data[i * bs: (i + 1) * bs]
                blocks[i, : len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
                lens[i] = len(chunk)

        self.block_statuses = [BlockStatus(i) for i in range(nblocks)]
        try:
            with self.metrics.stage("device_encode"), trace_span("compu/device_encode"):
                result = self.block_fn(blocks, lens)
        except Exception as exc:
            for st in self.block_statuses:
                st.state, st.error = BlockState.Failed, str(exc)
            raise
        out, out_lens, checks, *rest = result
        seg_index = rest[0] if rest else None
        out_lens = np.asarray(out_lens)
        checks = np.asarray(checks)

        cap = bs + bs // 4 + 64
        for i in range(nblocks):
            if not 0 < int(out_lens[i]) <= cap:
                self.block_statuses[i].state = BlockState.Failed
                raise ValueError(f"block {i}: device output length {int(out_lens[i])} "
                                 f"outside (0, {cap}]")
            self.metrics.record_block(int(lens[i]), int(out_lens[i]))

        with self.metrics.stage("assemble"):
            stream, index = self._assemble(out, out_lens, checks, lens, n)
        if seg_index is not None:
            index.segment_bits = [seg_index[i] for i in range(nblocks)]
        return stream, index

    def _assemble(self, out, out_lens, checks, lens, n):
        # The header carries level 6's hint whatever the step's level, as
        # the reference's scheduler writes it.
        stream = bytearray(stream_header(self.mode, 6))
        index = BlockIndex([], [], [])
        for i in range(len(lens)):
            index.raw_lengths.append(int(lens[i]))
            index.compressed_offsets.append(len(stream))
            index.compressed_lengths.append(int(out_lens[i]))
            stream.extend(np.asarray(out[i])[: int(out_lens[i])].tobytes())
        # Closing: an empty FINAL stored block terminates the deflate stream.
        stream.extend(bytes([0x01, 0x00, 0x00, 0xFF, 0xFF]))

        if self.mode is ZlibMode.Zlib:
            total = 1
            for i in range(len(lens)):
                total = checksum.adler32_combine(total, int(checks[i]), int(lens[i]))
            stream.extend(struct.pack(">I", total))
        elif self.mode is ZlibMode.Gzip:
            total = 0
            for i in range(len(lens)):
                total = checksum.crc32_combine(total, int(checks[i]), int(lens[i]))
            stream.extend(struct.pack("<II", total, n & 0xFFFFFFFF))
        return bytes(stream), index
