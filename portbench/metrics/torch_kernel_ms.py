"""Device ms a request of the kernels that are not the port's own
(``compu_tpu_torch/csrc``): the plain PyTorch stages."""

from .. import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_requests:
        return None
    plain = ~t.is_copy & ~tr.calls(t.names, ctx.program_kernels)
    if not plain.any():
        return None
    return float((t.end - t.start)[plain].sum()) * 1e-6 / t.n_requests
