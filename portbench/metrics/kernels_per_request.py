"""The card's kernels in the traced window (copies left out), over its
requests."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_requests or not t.names:
        return None
    return float((~t.is_copy).sum()) / t.n_requests
