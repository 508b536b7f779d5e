"""Host ms a request in the port's framing (``BlockParallelEncoder``'s
``stage_blocks`` and ``assemble`` stages, its own clock)."""

from ._host import mean_of


def read(ctx):
    return mean_of(ctx, "framing_ms")
