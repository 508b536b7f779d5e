"""Status model of the streaming encoder (the encode half).

The port's copy of the encode types in ``compu_tpu/status.py``:

- ``EncodeOp {Process, Flush, Finish}``: what the caller asks of the encoder;
- ``EncodeStatus {Continue, NeedOutput, Finished, Error}``;
- ``Encode {input_remain, output_remain, status}``: the outcome of one call.

``input_remain`` / ``output_remain`` are the byte counts left unused in the
buffers passed to the call, so a caller can suspend at any chunk boundary
and resume later. ``reset()`` re-arms the encoder for a new stream.
"""

from __future__ import annotations

import dataclasses
import enum


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
