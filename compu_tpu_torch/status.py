"""Status model of the streaming encoder and decoder.

The port's copy of ``compu_tpu/status.py``:

- ``DecodeStatus {NeedInput, NeedOutput, Finished}``, and ``DecodeError``,
  a typed error wrapping the backend's code;
- ``Decode {input_remain, output_remain, status}``: the outcome of one
  decode call, whose ``status`` is a ``DecodeStatus`` or a ``DecodeError``;
- ``EncodeOp {Process, Flush, Finish}``: what the caller asks of the encoder;
- ``EncodeStatus {Continue, NeedOutput, Finished, Error}``;
- ``Encode {input_remain, output_remain, status}``: the outcome of one call.

``input_remain`` / ``output_remain`` are the byte counts left unused in the
buffers passed to the call, so a caller can suspend at any chunk boundary
and resume later. ``reset()`` re-arms the encoder or decoder for a new
stream.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Union


class DecodeStatus(enum.Enum):
    """Result of a successful decode step."""

    #: All input consumed; more input is required to make progress.
    NeedInput = "need_input"
    #: Output buffer has no more space (or undrained data remains internally).
    NeedOutput = "need_output"
    #: Stream fully decoded and trailer verified.
    Finished = "finished"


@dataclasses.dataclass(frozen=True)
class DecodeError:
    """Typed decode error wrapping the backend's code;
    ``Decoder.describe_error`` maps it to a static message."""

    code: int

    @staticmethod
    def no_error() -> "DecodeError":
        """Placeholder error (code 0) whose description is the generic
        message."""
        return DecodeError(0)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"DecodeError(code={self.code})"


@dataclasses.dataclass(frozen=True)
class Decode:
    """Outcome of one decode call."""

    #: Bytes of the provided input that were NOT consumed.
    input_remain: int
    #: Bytes of the provided output buffer that were NOT written.
    output_remain: int
    status: Union[DecodeStatus, DecodeError]

    @property
    def is_error(self) -> bool:
        return isinstance(self.status, DecodeError)


class EncodeOp(enum.Enum):
    """Operation requested from the encoder."""

    #: Compress input lazily; the encoder may buffer internally.
    Process = "process"
    #: Emit all buffered data at a byte-aligned resume point.
    Flush = "flush"
    #: Finalize the stream (trailer + checksum). Input may be empty.
    Finish = "finish"


class EncodeStatus(enum.Enum):
    """Result of one encode call."""

    #: Operation completed; encoder can accept more input.
    Continue = "continue"
    #: Output buffer exhausted; provide more space and repeat the op.
    NeedOutput = "need_output"
    #: Stream finalized (only after ``EncodeOp.Finish``).
    Finished = "finished"
    #: Encoder failed; state is unusable until ``reset()``.
    Error = "error"


@dataclasses.dataclass(frozen=True)
class Encode:
    """Outcome of one encode call."""

    input_remain: int
    output_remain: int
    status: EncodeStatus

    @property
    def is_error(self) -> bool:
        return self.status is EncodeStatus.Error
