"""Share, in %, of the traced window in which the card ran no kernel and
no copy."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
