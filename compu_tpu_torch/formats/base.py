"""Backend plumbing shared by the format pipelines (the port's copy of
``DecoderBackend``, ``EncoderBackend`` and ``CodecFailure`` from
``compu_tpu/formats/base.py``).

A decoder backend stages input, lets its format decode as far as the
staged bytes allow, and drains the decoded bytes through the caller's
buffers. Undrained output is bounded: once it passes
``pending_high_water``, further input is refused (reported in
``input_remain``) until the caller drains.

An encoder backend stages input, cuts it into ``block_size`` chunks at
absolute stream offsets (so chunked and one-shot encodes give the same
bytes), compresses each chunk, and drains the output through the caller's
buffers. Undrained output is bounded the same way: once it passes
``pending_high_water``, ``Process`` refuses further input.
"""

from __future__ import annotations

from typing import Optional

from ..status import Decode, DecodeError, DecodeStatus, Encode, EncodeOp, EncodeStatus


class CodecFailure(Exception):
    """Raised by a format stage on a malformed stream, or one that cannot
    code its input. ``code`` is the format's error number: a decoder
    surfaces it as ``DecodeError``; the zstd encoder catches it and writes
    the part raw instead."""

    def __init__(self, code: int, message: str = "corrupt stream") -> None:
        super().__init__(message)
        self.code = code
        self.message = message


class DecoderBackend:
    """Base class for decode pipelines. Subclasses implement:

    * ``_pump()``: consume bytes from ``self._staged`` starting at
      ``self._staged_pos`` (advancing it), append decoded bytes to
      ``self._pending``, and set ``self._finished = True`` once the stream's
      trailer has been consumed and verified. Must be resumable: called
      whenever new input arrives; decode as far as the available bytes
      allow and return (keeping any partial-unit tail unconsumed).
      Raise :class:`CodecFailure` on corruption.
    * ``_do_reset()``: drop all stream state; options survive.
    * ``ERRORS``: dict code -> static message for ``describe_error``.
    """

    name = "?"
    ERRORS: dict[int, str] = {}
    #: Back-pressure threshold: once this many undrained decoded bytes are
    #: pending, new input is refused (reported via ``input_remain``) until
    #: the caller drains output.
    pending_high_water = 1 << 20

    def __init__(self) -> None:
        self._init_stream_state()

    def _init_stream_state(self) -> None:
        self._staged = bytearray()
        self._staged_pos = 0
        self._pending = bytearray()
        self._pending_pos = 0
        self._finished = False
        self._error: Optional[DecodeError] = None

    # -- hooks ---------------------------------------------------------------
    def _pump(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _do_reset(self) -> None:
        pass

    def _rebase_input(self, nbytes: int) -> None:
        """Notify the format that ``nbytes`` were dropped from the front of
        ``_staged`` (compaction); formats keeping absolute offsets into the
        staged buffer shift them here. Default: nothing keeps offsets."""

    #: Optional zero-copy fast path. When set (a callable ``(inp, out) ->
    #: (consumed, written, DecodeStatus) | None``), ``decode`` tries it
    #: first whenever nothing is staged or pending: the backend may then
    #: stream the caller's bytes straight through its state machine into
    #: the caller's buffer. Returning None takes the staged path. The hook
    #: may stage an unconsumed tail itself (``_staged``/``_staged_pos``)
    #: and must set ``_finished`` once the trailer is verified.
    _decode_direct = None

    # -- internal helpers -----------------------------------------------------
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

    def _compact_staged(self) -> None:
        if self._staged_pos > (1 << 16):
            drop = self._staged_pos
            del self._staged[:drop]
            self._staged_pos = 0
            self._rebase_input(drop)

    # -- generic state machine ----------------------------------------------
    def decode(self, inp, out) -> Decode:
        inp = memoryview(inp).cast("B") if len(inp) else memoryview(b"")
        out = memoryview(out).cast("B") if len(out) else memoryview(bytearray())
        if self._error is not None:
            return Decode(len(inp), len(out), self._error)

        # Drain already-pending bytes first so back-pressure releases as
        # soon as the caller offers output space.
        written = self._drain(out)
        consumed = 0
        if (self._decode_direct is not None
                and not self._finished
                and self._staged_pos == len(self._staged)
                and self._pending_pos == len(self._pending)):
            try:
                res = self._decode_direct(inp, out[written:])
            except CodecFailure as failure:
                self._error = DecodeError(failure.code)
                return Decode(len(inp), len(out), self._error)
            if res is not None:
                consumed_d, written_d, status = res
                return Decode(len(inp) - consumed_d,
                              len(out) - written - written_d, status)
        backlog = len(self._pending) - self._pending_pos
        if not self._finished and backlog < self.pending_high_water:
            self._staged.extend(inp)
            consumed = len(inp)
            # Pump until the stream finishes, back-pressure engages, or the
            # format genuinely needs more input (no progress). A single
            # pump can stop early at its sink budget; with a large caller
            # buffer the drain empties pending again, so keep going —
            # otherwise the call would report NeedInput with decodable
            # input still staged.
            while True:
                before_pos = self._staged_pos
                before_avail = len(self._pending) - self._pending_pos
                try:
                    self._pump()
                except CodecFailure as failure:
                    self._error = DecodeError(failure.code)
                    return Decode(len(inp), len(out), self._error)
                progressed = (
                    self._staged_pos != before_pos
                    or len(self._pending) - self._pending_pos != before_avail
                )
                self._compact_staged()
                if self._finished:
                    # Bytes past the end of the stream are not ours to
                    # consume; attribute the excess to the current input
                    # slice.
                    excess = len(self._staged) - self._staged_pos
                    consumed = len(inp) - min(excess, len(inp))
                    break
                written += self._drain(out[written:])
                if not progressed:
                    break
                if len(self._pending) - self._pending_pos >= self.pending_high_water:
                    break
            written += self._drain(out[written:])
        if len(self._pending) - self._pending_pos > 0:
            status = DecodeStatus.NeedOutput
        elif self._finished:
            status = DecodeStatus.Finished
        else:
            status = DecodeStatus.NeedInput
        return Decode(len(inp) - consumed, len(out) - written, status)

    def reset(self) -> bool:
        self._init_stream_state()
        self._do_reset()
        return True

    def describe_error(self, code: int) -> Optional[str]:
        if code == 0:
            return "unknown error"  # DecodeError.no_error()
        return self.ERRORS.get(code)


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
