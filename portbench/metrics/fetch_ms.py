"""Host ms a request in the block step's fetch of the compressed bytes
(``fn.last_timings["payload_d2h_ms"]``)."""

from ._host import mean_of


def read(ctx):
    return mean_of(ctx, "fetch_ms")
