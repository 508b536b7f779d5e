"""Foreign-stream device inflate: the speculative-resync driver and its
streaming backend (``decoder.Interface.zlib_device``).

The port's copy of ``compu_tpu/formats/deflate/device_inflate.py``. It
decodes any deflate, zlib or gzip stream, with no side index:

* on the host: the framing headers, each deflate block's header (bit by
  bit), the walk of each wave's exit phases along the true path, stored
  blocks, and the trailer checks (stdlib ``zlib.crc32``/``adler32``);
* on the device: the speculative 48-phase chunk scan (kernel P4,
  ``kernels/inflate_spec.py``), one launch a wave of 256 chunks, with each
  block's code tables, built in numpy on the host and uploaded once a
  block; and the stream-global expansion and back-reference resolution
  (the window crosses deflate blocks).

A wave costs one launch and two fetches: the lanes' exit phases, EOB bits,
flags and record counts in one copy, then the true lanes' defined records
(their first ``nrec`` slots), gathered on the device. Like the reference, ``_pump`` decodes the whole staged input again
on each call until the stream is complete, so feeding a stream in many
chunks costs time quadratic in their number.

Where it differs from the reference: a stream that ends inside a block
header waits for input (NeedInput), as it does inside a block body; the
reference lets the bit reader's ``NeedMoreBits`` escape. ``device`` names a
torch device: None is CUDA, ``"cpu"`` runs the plain versions.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ...kernels.inflate_spec import (
    C,
    LANES,
    PHASES,
    WAVE_CHUNKS,
    build_foreign_tables,
    pad_stream,
    resolve_foreign,
    spec_scan_wave,
)
from ...ops.bitio import BitReader, NeedMoreBits
from ...ops.huffman import build_decode_table
from ..base import CodecFailure, DecoderBackend
from . import consts
from .inflate import ERRORS
from .options import ZlibDecodeOptions, ZlibMode


def parse_block_header_at(data: bytes, bit: int):
    """Parse ONE deflate block header starting at absolute ``bit``.

    Returns (kind, lit_lens[288], dist_lens[30], body_bit, bfinal): 288
    lengths include the phantom fixed-tree symbols 286/287, never emitted,
    whose 8-bit lengths shift every 9-bit code's canonical number. kind 0 =
    stored, 1 = fixed, 2 = dynamic; ``body_bit`` is the absolute bit where
    the block body (tokens or stored bytes) starts. Raises CodecFailure on
    corruption, ``NeedMoreBits`` when the header runs past the data."""
    r = BitReader(bytearray(data), 0)
    r.bitpos = bit
    bfinal = r.read(1)
    btype = r.read(2)
    lit = np.zeros(288, dtype=np.int32)
    dist = np.zeros(30, dtype=np.int32)
    if btype == 3:
        raise CodecFailure(-3, "invalid block type")
    if btype == 0:
        return 0, lit, dist, r.bitpos, bfinal
    if btype == 1:
        lit[:] = consts.FIXED_LITLEN_LENGTHS
        dist[:] = 5
        return 1, lit, dist, r.bitpos, bfinal
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise CodecFailure(-3, "bad HLIT/HDIST")
    clen_lengths = np.zeros(19, dtype=np.int64)
    for i in range(hclen):
        clen_lengths[consts.CLEN_ORDER[i]] = r.read(3)
    cl_syms, cl_lens = build_decode_table(clen_lengths, 7)
    lengths = np.zeros(hlit + hdist, dtype=np.int64)
    i = 0
    while i < hlit + hdist:
        idx = r.peek(7)
        n = int(cl_lens[idx])
        if n == 0:
            raise CodecFailure(-3, "bad code-length code")
        sym = int(cl_syms[idx])
        r.skip(n)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise CodecFailure(-3, "repeat with no previous length")
            rep = 3 + r.read(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + r.read(3)
        else:
            i += 11 + r.read(7)
    lit[:hlit] = lengths[:hlit]
    dist[:hdist] = lengths[hlit : hlit + hdist]
    return 2, lit, dist, r.bitpos, bfinal


class _Truncated(Exception):
    """Input ends before the stream completes (NeedInput)."""


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A device result on the host."""
    return t.cpu().numpy()


def _walk_wave(lanes: np.ndarray, wave_bit0: int, total_bits: int, phase: int):
    """The true path through one wave's exit phases, from ``phase`` in its
    first chunk: returns (true lanes, the phase it leaves the wave at, the
    block's EOB bit or -1). Raises _Truncated when a lane's span may pass
    the input (its verdict is unreliable: it decoded zeros), CodecFailure
    at a bad or overflowed lane."""
    exit_rel, eob_bits, flags = lanes
    true_lanes = []
    for k in range(WAVE_CHUNKS):
        lane = k * PHASES + phase
        if flags[lane] & 1 and int(eob_bits[lane]) <= total_bits:
            true_lanes.append(lane)
            return true_lanes, phase, int(eob_bits[lane])
        if wave_bit0 + (k + 1) * C + PHASES > total_bits:
            raise _Truncated
        if flags[lane] & 2:
            raise CodecFailure(-3, "invalid code in block body")
        true_lanes.append(lane)
        phase = int(exit_rel[lane])
    return true_lanes, phase, -1


def device_inflate_raw(data: bytes, start_bit: int, device):
    """Decode a COMPLETE raw-deflate stream starting at ``start_bit`` of
    ``data`` on ``device``. Returns (out_bytes, end_bit). Raises _Truncated
    when the input ends before the final block's EOB, CodecFailure on
    corruption."""
    dev = torch.device(device)
    total_bits = len(data) * 8
    comp = pad_stream(data, dev)

    bit = start_bit
    out_pos = 0
    tok_outlen: list[np.ndarray] = []
    tok_islit: list[np.ndarray] = []
    tok_payload: list[np.ndarray] = []
    tok_start: list[np.ndarray] = []
    stored_ranges: list[tuple[int, bytes]] = []

    while True:
        try:
            kind, lit, dist, body_bit, bfinal = parse_block_header_at(data, bit)
        except (IndexError, struct.error, NeedMoreBits):
            raise _Truncated
        if body_bit > total_bits:
            raise _Truncated
        if kind == 0:
            byte = (body_bit + 7) // 8
            if byte + 4 > len(data):
                raise _Truncated
            ln, nln = struct.unpack_from("<HH", data, byte)
            if ln ^ nln != 0xFFFF:
                raise CodecFailure(-3, "stored LEN/NLEN mismatch")
            if byte + 4 + ln > len(data):
                raise _Truncated
            stored_ranges.append((out_pos, data[byte + 4 : byte + 4 + ln]))
            out_pos += ln
            bit = (byte + 4 + ln) * 8
        else:
            tables = build_foreign_tables(lit, dist, dev)
            # Scan 16 KiB of compressed bits a launch until the true path
            # reaches this block's EOB.
            wave_bit0 = body_bit
            phase = 0
            eob_bit = -1
            while eob_bit < 0:
                if wave_bit0 >= total_bits:
                    raise _Truncated
                lanes, rec = spec_scan_wave(comp, tables, wave_bit0, total_bits)
                exit_rel, eob_bits, flags, nrec = _fetch(lanes[:4])
                true_lanes, phase, eob_bit = _walk_wave((exit_rel, eob_bits, flags), wave_bit0,
                                                        total_bits, phase)
                # Their records: slot k of lane l is rec[k, l], k < nrec[l].
                n = nrec[true_lanes].astype(np.int64)
                total = int(n.sum())
                if total:
                    first = np.cumsum(n) - n
                    slot = np.arange(total) - np.repeat(first, n)
                    sel = slot * LANES + np.repeat(np.asarray(true_lanes, np.int64), n)
                    recs = _fetch(rec.reshape(-1)[torch.from_numpy(sel).to(dev)])
                    ol = recs & 0x1FF
                    tok_outlen.append(ol)
                    tok_islit.append((recs >> 9) & 1)
                    tok_payload.append((recs >> 10) & 0x7FFF)
                    tok_start.append(out_pos + np.cumsum(ol, dtype=np.int64) - ol)
                    out_pos += int(ol.sum())
                wave_bit0 += WAVE_CHUNKS * C
            bit = eob_bit
        if bfinal:
            break
    total_out = out_pos

    if total_out == 0:
        return b"", bit
    if tok_outlen:
        ol = np.concatenate(tok_outlen)
        il = np.concatenate(tok_islit)
        pay = np.concatenate(tok_payload)
        st = np.concatenate(tok_start)
        # window validity: distances must not reach before the stream start
        mi = il == 0
        if np.any(st[mi] - (pay[mi] + 1) < 0):
            raise CodecFailure(-3, "distance too far back")
    else:
        ol = il = pay = np.zeros(0, np.int32)
        st = np.zeros(0, np.int64)

    stored_out = np.zeros(total_out, np.uint8)
    stored_mask = np.zeros(total_out, bool)
    for off, blob in stored_ranges:
        stored_out[off : off + len(blob)] = np.frombuffer(blob, np.uint8)
        stored_mask[off : off + len(blob)] = True
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (ol, il, pay, st, stored_out, stored_mask)]
    out, ok = resolve_foreign(*up, total_out=total_out)
    if int(_fetch(ok)[0]) != 1:
        raise CodecFailure(-3, "unresolved back-references")
    return _fetch(out).tobytes(), bit


def _parse_gzip_header(data: bytes) -> int:
    """Return the byte offset where deflate data starts; raises _Truncated
    if the (variable-length) header is incomplete, CodecFailure if bad."""
    if len(data) < 10:
        raise _Truncated
    if data[0] != 0x1F or data[1] != 0x8B or data[2] != 8:
        raise CodecFailure(-3, "bad gzip magic/method")
    flg = data[3]
    pos = 10
    if flg & 4:  # FEXTRA
        if len(data) < pos + 2:
            raise _Truncated
        xlen = struct.unpack_from("<H", data, pos)[0]
        pos += 2 + xlen
    if flg & 8:  # FNAME
        end = data.find(b"\0", pos)
        if end < 0:
            raise _Truncated
        pos = end + 1
    if flg & 16:  # FCOMMENT
        end = data.find(b"\0", pos)
        if end < 0:
            raise _Truncated
        pos = end + 1
    if flg & 2:  # FHCRC
        pos += 2
    if len(data) < pos:
        raise _Truncated
    return pos


def _check_trailer(mode: ZlibMode, data: bytes, out: bytes, end_bit: int) -> int:
    """Verify the gzip (crc32, isize) or zlib (adler32) trailer after the
    deflate data ending at ``end_bit``; returns the bytes the stream takes.
    Raises _Truncated if the trailer is incomplete, CodecFailure if wrong."""
    tail = (end_bit + 7) // 8
    if mode is ZlibMode.Gzip:
        if tail + 8 > len(data):
            raise _Truncated
        crc, isize = struct.unpack_from("<II", data, tail)
        if zlib.crc32(out) != crc:
            raise CodecFailure(-3, "gzip crc mismatch")
        if isize != (len(out) & 0xFFFFFFFF):
            raise CodecFailure(-3, "gzip isize mismatch")
        return tail + 8
    if mode is ZlibMode.Zlib:
        if tail + 4 > len(data):
            raise _Truncated
        if zlib.adler32(out) != struct.unpack_from(">I", data, tail)[0]:
            raise CodecFailure(-3, "adler mismatch")
        return tail + 4
    return tail


class DeviceDeflateDecoder(DecoderBackend):
    """Streaming zlib/gzip/deflate decoder over the foreign-stream
    speculative device inflate, on ``device`` (None: CUDA; ``"cpu"`` runs
    the kernel's plain version)."""

    name = "zlib-device"
    ERRORS = ERRORS

    def __init__(self, options: ZlibDecodeOptions | ZlibMode | None = None,
                 device=None) -> None:
        if options is None:
            options = ZlibDecodeOptions()
        if isinstance(options, ZlibMode):
            options = ZlibDecodeOptions(mode=options)
        self.options = options
        self.device = torch.device("cuda" if device is None else device)
        super().__init__()

    def _pump(self) -> None:
        if self._finished:
            return
        data = bytes(self._staged[self._staged_pos :])
        if not data:
            return
        mode = self.options.mode
        try:
            if mode is ZlibMode.Auto:
                if len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B:
                    mode = ZlibMode.Gzip
                elif len(data) >= 2 and data[0] & 0x0F == 8 \
                        and ((data[0] << 8) | data[1]) % 31 == 0:
                    mode = ZlibMode.Zlib
                else:
                    mode = ZlibMode.Deflate
            if mode is ZlibMode.Gzip:
                start = _parse_gzip_header(data)
            elif mode is ZlibMode.Zlib:
                if len(data) < 2:
                    raise _Truncated
                cmf, flg = data[0], data[1]
                if cmf & 0x0F != 8 or ((cmf << 8) | flg) % 31 != 0:
                    raise CodecFailure(-3, "bad zlib header")
                start = 2
            else:  # raw deflate
                start = 0
            out, end_bit = device_inflate_raw(data, start * 8, self.device)
            consumed = _check_trailer(mode, data, out, end_bit)
        except _Truncated:
            return  # NeedInput: wait for more bytes, consume nothing
        self._pending.extend(out)
        self._staged_pos += consumed
        self._finished = True
