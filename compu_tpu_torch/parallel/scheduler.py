"""Block-parallel stream encoder and decoder for the port (pigz-style).

The port's copy of ``compu_tpu/parallel/scheduler.py``. A buffer is cut
into fixed-size independent blocks, the device step encodes them, and the
host assembles ONE standard zlib/gzip stream:

* every block is a self-contained run of deflate blocks ending in an empty
  stored block (Z_SYNC_FLUSH), so block outputs are byte-aligned and
  concatenate freely;
* matches never cross block boundaries, so any block decodes from its own
  bytes;
* the per-block checksums from the device merge on the host with the
  combine algebra (``ops/checksum.py``);
* the encoder records a block index (compressed offset, raw length).

The block step is the device encode (``kernels/block_codec.py``) or the
host engine ``make_host_block_encode_fn``: one host-runtime deflate call a
block in a thread pool, behind the same step contract and stream format.
``parallel_zstd_compress`` is the zstd counterpart, one host-runtime frame
a slice, the frames concatenated.

``BlockParallelDecoder`` reads such a stream back with its index: on the
device by default, each batch of 16 blocks one scan of kernel P3 and the
expansion and resolution of ``kernels/inflate.py``, or on the host when
asked for (``host=True``: the host runtime's whole-block inflate, one
ctypes call a block, in a thread pool).

The port has no host fallback either way: a failed device step, or a
block whose output is implausible, marks the blocks failed and raises, so
a fault on the card is never hidden behind a host codec.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..formats.deflate.options import ZlibMode, stream_header
from ..ops import checksum
from ..ops.bitio import BitReader
from ..utils.metrics import Metrics, trace_span

__all__ = ["BlockIndex", "BlockParallelDecoder", "BlockParallelEncoder", "BlockState",
           "BlockStatus", "make_host_block_encode_fn", "parallel_zstd_compress"]


class BlockState:
    """Per-block scheduler status."""

    Ok = "ok"
    Failed = "failed"  # the step failed; the stream aborts


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


class BlockParallelDecoder:
    """Decode a block-parallel stream with its side index.

    Each block's bytes decode on their own (window reset, byte alignment).
    By default the blocks decode on ``device`` (None: CUDA; ``"cpu"`` runs
    the kernels' plain versions): batches of ``DEVICE_DECODE_BATCH`` blocks,
    each block's header parsed on the host into code lengths, stored blocks
    copied on the host (``_stored_copy``), every other block one row of the
    batch's scan. A batch whose codes are all at most 12 bits takes the LUT
    route, another the dyn route. Every batch is decoded before the first
    result is fetched, and on CUDA no host read remains before that fetch:
    a batch's scan (P3), expansion (P7) and pointer doubling (P6) keep
    their counts on the device, so the host parses the next batch's
    headers while the card decodes this one (the next upload, a pageable
    copy, then waits for it).
    The device route needs the index's ``segment_bits``; a batch that fails
    its consistency check raises ``ValueError``.

    ``host=True`` decodes every block on the host, one call into the host
    runtime's C++ inflate a block (the call releases the GIL, so the
    thread pool's workers decode in parallel), and is never taken
    otherwise. ``host_fallback`` is accepted
    for the reference's signature and must stay False. A failure marks the
    blocks ``Failed`` and raises."""

    DEVICE_DECODE_BATCH = 16

    def __init__(self, *, block_size: int = 1 << 18, device=None, host: bool = False,
                 host_fallback: bool = False):
        if host_fallback:
            raise ValueError("the port has no host fallback: a device fault raises")
        if block_size <= 0 or block_size % 128:
            raise ValueError(f"block_size must be a positive multiple of 128, got {block_size}")
        self.block_size = block_size
        self.device = torch.device("cuda" if device is None else device)
        self.host = host
        #: Per-block statuses of the last decode() (BlockStatus list).
        self.block_statuses: list[BlockStatus] = []

    def decode(self, stream: bytes, index: BlockIndex) -> bytes:
        nblocks = len(index.raw_lengths)
        self.block_statuses = [BlockStatus(i) for i in range(nblocks)]
        if self.host:
            return self._decode_host(stream, index)
        try:
            if index.segment_bits is None:
                raise ValueError("the index has no segment_bits: the device route needs them")
            return self._decode_device(stream, index)
        except Exception as exc:
            for st in self.block_statuses:
                st.state, st.error = BlockState.Failed, str(exc)
            raise

    def _decode_host(self, stream: bytes, index: BlockIndex) -> bytes:
        def one(i, off, clen, rlen):
            try:
                return _host_inflate_block(stream[off: off + clen], rlen)
            except Exception as exc:
                self.block_statuses[i].state = BlockState.Failed
                self.block_statuses[i].error = str(exc)
                raise

        jobs = list(zip(range(len(index.raw_lengths)), index.compressed_offsets,
                        index.compressed_lengths, index.raw_lengths))
        workers = min(os.cpu_count() or 1, len(jobs), 8)
        if workers <= 1:
            return b"".join(one(*j) for j in jobs)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(one, *j) for j in jobs]
            return b"".join(f.result() for f in futs)

    def _decode_device(self, stream: bytes, index: BlockIndex) -> bytes:
        from ..kernels.inflate_dyn import decode_blocks_indexed_dyn, parse_block_tables
        from ..kernels.inflate_lut import LUT_BITS, decode_blocks_indexed_lut

        bs = self.block_size
        cap = bs + bs // 4 + 64 + 16
        nblocks = len(index.raw_lengths)
        batch = self.DEVICE_DECODE_BATCH
        runs = []
        host_pieces: dict[int, bytes] = {}
        for base in range(0, nblocks, batch):
            cnt = min(batch, nblocks - base)
            comps = np.zeros((batch, cap), dtype=np.uint8)
            segs = np.zeros((batch, bs // 128), dtype=np.int32)
            ns = np.zeros(batch, dtype=np.int32)
            lit_lens = np.zeros((batch, 288), dtype=np.int32)
            dist_lens = np.zeros((batch, 30), dtype=np.int32)
            lit_lens[:, [0, 256]] = 1  # complete-ish tables for the inert rows
            dist_lens[:, [0, 1]] = 1
            for j in range(cnt):
                b = base + j
                off, clen = index.compressed_offsets[b], index.compressed_lengths[b]
                rlen = index.raw_lengths[b]
                blob = stream[off: off + clen]
                kind, lit, dist, _ = parse_block_tables(blob[:4096])
                if kind == 0 or int(np.asarray(index.segment_bits[b])[0]) < 0:
                    host_pieces[b] = _stored_copy(blob, rlen)
                    continue
                if clen > cap - 12 or not 0 < rlen <= bs:
                    raise ValueError(f"block {b}: {clen} compressed bytes for {rlen} "
                                     f"does not fit blocks of {bs}")
                comps[j, :clen] = np.frombuffer(blob, dtype=np.uint8)
                segs[j] = np.asarray(index.segment_bits[b], dtype=np.int32)
                ns[j] = rlen
                lit_lens[j] = lit
                dist_lens[j] = dist
            decode = (decode_blocks_indexed_lut
                      if max(int(lit_lens.max()), int(dist_lens.max())) <= LUT_BITS
                      else decode_blocks_indexed_dyn)
            dev = _upload((comps, segs, ns, lit_lens, dist_lens), self.device)
            runs.append((*decode(*dev, n_out=bs), base, cnt))
        oks = _fetch(torch.cat([ok for _, ok, _, _ in runs])) if runs else []
        pieces = []
        for (out, _, base, cnt), ok in zip(runs, oks):
            if int(ok) != 1:
                raise ValueError("device inflate failed consistency checks")
            flat = _fetch(out)
            for j in range(cnt):
                b = base + j
                if b in host_pieces:
                    pieces.append(host_pieces[b])
                else:
                    pieces.append(flat[j * bs: j * bs + index.raw_lengths[b]].tobytes())
        return b"".join(pieces)


def _pool_map(fn, items, workers: int | None) -> list:
    """``fn`` over ``items`` in order, on a thread pool of ``workers``
    (default ``min(cpu_count, 8)``) when there is more than one item."""
    nworkers = workers or min(os.cpu_count() or 1, 8)
    if len(items) > 1 and nworkers > 1:
        with ThreadPoolExecutor(max_workers=min(nworkers, len(items))) as pool:
            return list(pool.map(fn, items))
    return [fn(x) for x in items]


def make_host_block_encode_fn(mode: ZlibMode, level: int = 6, workers: int | None = None):
    """The scheduler's host engine: a step with ``BlockParallelEncoder``'s
    contract that encodes each block with one host-runtime deflate call
    (``_NativeDeflateStream``; a fresh stream a block keeps the blocks
    independent) and its sync flush, and checks it with the host runtime's
    adler32 (zlib) or crc32 (otherwise). The calls release the GIL, so the
    blocks of a batch run on a thread pool of ``workers``. It touches no
    device."""
    from ..formats.deflate.pipeline import _NativeDeflateStream

    def encode_one(data: bytes):
        s = _NativeDeflateStream(level)
        blob = s.compress(data, final=False) + s.sync_flush()
        chk = checksum.adler32(data, 1) if mode is ZlibMode.Zlib else checksum.crc32(data, 0)
        return blob, chk

    def fn(blocks, lens):
        datas = [blocks[i, : int(lens[i])].tobytes() for i in range(blocks.shape[0])]
        results = _pool_map(encode_one, datas, workers)
        out = [np.frombuffer(blob, dtype=np.uint8) for blob, _ in results]
        out_lens = np.asarray([len(blob) for blob, _ in results], np.int64)
        checks = np.asarray([chk for _, chk in results], np.uint32)
        return out, out_lens, checks

    return fn


def parallel_zstd_compress(data: bytes, level: int = 3, frame_size: int = 1 << 20,
                           workers: int | None = None, window_log: int = 21,
                           checksum_frames: bool = True) -> bytes:
    """Frame-parallel zstd encode: each ``frame_size`` slice becomes one
    complete frame of the host runtime's standalone encoder
    (``NativeZstdStream``, which releases the GIL), on a thread pool of
    ``workers``; the concatenation is a standard multi-frame zstd stream.
    It touches no device."""
    from ..formats.zstd.native_enc2 import NativeZstdStream

    chunks = [data[i:i + frame_size] for i in range(0, max(len(data), 1), frame_size)]

    def one(chunk: bytes) -> bytes:
        s = NativeZstdStream(level=level, window_log=window_log, checksum=checksum_frames)
        return s.compress_chunk(chunk, final=True)

    return b"".join(_pool_map(one, chunks, workers))


def _upload(arrays, device) -> list[torch.Tensor]:
    """A batch's numpy arrays as tensors on ``device``."""
    return [torch.from_numpy(a).to(device) for a in arrays]


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A device result on the host."""
    return t.cpu().numpy()


def _stored_copy(blob: bytes, raw_len: int) -> bytes:
    """A block of stored deflate blocks (BTYPE 00): each sub-block's bytes
    copied after its LEN == ~NLEN check, up to the end of ``blob`` (the
    sync flush is an empty one). Raises on another block type, a length
    mismatch, a sub-block past the end, or a total other than ``raw_len``.
    No entropy decode: the reference's host memcpy of a stored block."""
    r = BitReader(blob)
    out = bytearray()
    while r.remaining_bits() >= 8:
        r.read(1)  # bfinal
        if r.read(2) != 0:
            raise ValueError("a stored block holds a block that is not stored")
        r.align_byte()
        at = r.bitpos >> 3
        if at + 4 > len(blob):
            raise ValueError("stored block header past the end of the block")
        ln, nln = struct.unpack_from("<HH", blob, at)
        if ln != nln ^ 0xFFFF:
            raise ValueError(f"stored block LEN {ln} does not match NLEN {nln}")
        if at + 4 + ln > len(blob):
            raise ValueError("stored block bytes past the end of the block")
        out += blob[at + 4: at + 4 + ln]
        r.bitpos = (at + 4 + ln) * 8
    if len(out) != raw_len:
        raise ValueError(f"stored block copied {len(out)} bytes, expected {raw_len}")
    return bytes(out)


def _host_inflate_block(blob: bytes, raw_len: int) -> bytes:
    """One block (a raw deflate run ending in a sync flush) inflated by one
    ctypes call into the host runtime's whole-block C decoder, for the
    explicit host route. Raises unless the block decodes to its
    ``raw_len`` bytes and the stream's end."""
    import ctypes

    from ..runtime import native

    # Terminate the non-final run so the state machine reaches its end.
    payload = bytes(blob) + b"\x01\x00\x00\xff\xff"
    lib = native.lib()
    h = lib.compu_inflate_new()
    try:
        out = ctypes.create_string_buffer(raw_len + 8)
        arr = (ctypes.c_ubyte * len(payload)).from_buffer_copy(payload)
        consumed = ctypes.c_size_t(0)
        written = ctypes.c_size_t(0)
        st = lib.compu_inflate_run(
            h, ctypes.cast(arr, ctypes.POINTER(ctypes.c_ubyte)), len(payload),
            out, raw_len + 8, ctypes.byref(consumed), ctypes.byref(written))
    finally:
        lib.compu_inflate_free(h)
    if st != 2 or written.value != raw_len:  # 2: the stream's end
        raise ValueError(f"block decoded {written.value} bytes with status {st}, "
                         f"expected {raw_len} and the end")
    return out.raw[:raw_len]
