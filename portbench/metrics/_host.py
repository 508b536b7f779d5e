"""The mean, over the traced window's requests, of a host time the
system's entry reported for each."""


def mean_of(ctx, key: str):
    vals = [r[key] for r in ctx.requests if key in r]
    return sum(vals) / len(vals) if vals else None
