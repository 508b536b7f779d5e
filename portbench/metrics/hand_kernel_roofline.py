"""Share, in %, of their roofline that the hand kernels B1-B3 and P5
reach in the traced window: the bound of every request's batch (the
larger of bytes over the card's peak bandwidth and operations over its
peak INT32 rate, a function at a time, ``roofline.py``) over the device
time of their launches."""

from .. import roofline
from .. import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_requests or not ctx.inputs:
        return None
    hand = tr.calls(t.names, set(roofline.KERNELS))
    spent = float((t.end - t.start)[hand].sum()) * 1e-9
    if spent <= 0:
        return None
    each = {}
    for data in ctx.inputs:
        if id(data) not in each:
            each[id(data)] = roofline.request_bound_s(data, ctx.block_size, ctx.matcher,
                                                      ctx.device_kind)
    if None in each.values():
        return None
    need = sum(each[id(d)] for d in ctx.inputs) * t.n_requests / len(ctx.inputs)
    return 100.0 * need / spent
