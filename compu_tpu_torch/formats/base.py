"""The encode half of the backend plumbing (the port's copy of
``EncoderBackend`` and ``CodecFailure`` from ``compu_tpu/formats/base.py``).

An encoder backend stages input, cuts it into ``block_size`` chunks at
absolute stream offsets (so chunked and one-shot encodes give the same
bytes), compresses each chunk, and drains the output through the caller's
buffers. Undrained output is bounded: once it passes
``pending_high_water``, ``Process`` refuses further input (reported in
``input_remain``) until the caller drains.
"""

from __future__ import annotations

from ..status import Encode, EncodeOp, EncodeStatus


class CodecFailure(Exception):
    """Raised by a format stage that cannot code its input (``code`` is
    the format's error number); the zstd encoder catches it and writes the
    part raw instead."""

    def __init__(self, code: int, message: str = "corrupt stream") -> None:
        super().__init__(message)
        self.code = code
        self.message = message


class EncoderBackend:
    """Base class for encode pipelines. Subclasses implement:

    * ``_header() -> bytes``: stream header, emitted once lazily.
    * ``_compress(data, final) -> bytes``: compress one complete chunk;
      called with ``final=True`` exactly once, on Finish (possibly with
      empty ``data``).
    * ``_flush_mark() -> bytes``: byte-aligned sync point for Flush.
    * ``_trailer() -> bytes``: stream trailer (checksums, frame end).
    * ``_do_reset()``: drop stream state, keep options.
    """

    name = "?"
    block_size = 1 << 20

    @property
    def pending_high_water(self) -> int:
        """Back-pressure threshold for undrained compressed output."""
        return self.block_size + (1 << 16)

    def __init__(self) -> None:
        self._init_stream_state()

    def _init_stream_state(self) -> None:
        self._staged = bytearray()
        self._pending = bytearray()
        self._pending_pos = 0
        self._finished = False
        self._header_emitted = False

    # -- hooks ---------------------------------------------------------------
    def _header(self) -> bytes:
        return b""

    def _compress(self, data: bytes, final: bool) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def _flush_mark(self) -> bytes:
        return b""

    def _trailer(self) -> bytes:
        return b""

    def _do_reset(self) -> None:
        pass

    # -- generic state machine ----------------------------------------------
    def _ensure_header(self) -> None:
        if not self._header_emitted:
            self._pending.extend(self._header())
            self._header_emitted = True

    def _compress_staged(self, final: bool) -> None:
        """Compress staged input in block_size chunks (all of it)."""
        self._ensure_header()
        view = bytes(self._staged)
        self._staged = bytearray()
        offset = 0
        if final and not view:
            self._pending.extend(self._compress(b"", True))
            return
        while offset < len(view):
            chunk = view[offset : offset + self.block_size]
            offset += len(chunk)
            is_last = final and offset >= len(view)
            self._pending.extend(self._compress(chunk, is_last))

    def _drain(self, out) -> int:
        """Move pending bytes into ``out``; returns bytes written."""
        avail = len(self._pending) - self._pending_pos
        n = min(avail, len(out))
        if n:
            out[:n] = self._pending[self._pending_pos : self._pending_pos + n]
            self._pending_pos += n
            if self._pending_pos == len(self._pending):
                self._pending = bytearray()
                self._pending_pos = 0
            elif self._pending_pos > (1 << 16):
                del self._pending[: self._pending_pos]
                self._pending_pos = 0
        return n

    def encode(self, inp, out, op: EncodeOp) -> Encode:
        inp = memoryview(inp).cast("B") if len(inp) else memoryview(b"")
        out = memoryview(out).cast("B") if len(out) else memoryview(bytearray())
        if self._finished and op is not EncodeOp.Finish:
            return Encode(len(inp), len(out), EncodeStatus.Error)
        written = self._drain(out)
        refused = 0
        if not self._finished:
            backlog = len(self._pending) - self._pending_pos
            if op is EncodeOp.Process and backlog >= self.pending_high_water:
                # Back-pressure: refuse input until the caller drains.
                # Flush and Finish always accept.
                refused = len(inp)
            else:
                self._staged.extend(inp)
            if op is EncodeOp.Process:
                # Compress only complete blocks; boundaries depend on
                # absolute offsets so chunked == one-shot.
                while len(self._staged) >= self.block_size:
                    self._ensure_header()
                    chunk = bytes(self._staged[: self.block_size])
                    del self._staged[: self.block_size]
                    self._pending.extend(self._compress(chunk, False))
            elif op is EncodeOp.Flush:
                self._compress_staged(final=False)
                self._pending.extend(self._flush_mark())
            elif op is EncodeOp.Finish:
                self._compress_staged(final=True)
                self._pending.extend(self._trailer())
                self._finished = True

        written += self._drain(out[written:])
        if len(self._pending) - self._pending_pos > 0:
            status = EncodeStatus.NeedOutput
        elif self._finished:
            status = EncodeStatus.Finished
        else:
            status = EncodeStatus.Continue
        return Encode(refused, len(out) - written, status)

    def reset(self) -> bool:
        self._init_stream_state()
        self._do_reset()
        return True
