"""Faults planted under the timed path of a block-encode cell, each of
which has to make ``correct`` come out false: the block step wrapped, the
rest of the run as it is. One chip: there is no exchange between chips to
leave out."""

import numpy as np


def stale(fn):
    """The step returns its first answer again: state left unchanged."""
    kept = []

    def step(blocks, lens):
        if not kept:
            kept.append(fn(blocks, lens))
        return kept[0]
    return step


def half_batch(fn):
    """Only the first half of the batch is encoded; its answers stand in
    for the rest."""
    def step(blocks, lens):
        h = len(blocks) // 2
        out = fn(blocks[:h], lens[:h])
        return tuple(x + x if isinstance(x, list) else np.concatenate([x, x]) for x in out)
    return step


def altered(fn):
    """One byte of one block's bytes is changed where the step makes it."""
    def step(blocks, lens):
        out, *rest = fn(blocks, lens)
        out = [np.array(o) for o in out]
        out[1][len(out[1]) // 2] ^= 0x20
        return (out, *rest)
    return step


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered}
