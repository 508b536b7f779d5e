"""Host ms a request in the block step's upload and launch enqueue
(``fn.last_timings["h2d_dispatch_ms"]``)."""

from ._host import mean_of


def read(ctx):
    return mean_of(ctx, "dispatch_ms")
