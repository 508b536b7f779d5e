"""The system under test of the block-encode configurations: the port's
flagship encode, built as its users build it.

``make_block_encode_fn(mode, level, segment_index=...)`` at its default
``pipeline_groups``, behind ``BlockParallelEncoder``; one request is one
``encode`` of an input. The benchmark wraps the block step in a span of its
own (``portbench/block_step``) and reads the program's host clocks after
each request: the framing stages of ``enc.metrics.stage_seconds`` and the
step's ``fn.last_timings``. The configuration's ``matcher`` is the level's
stated search, which the reference holds the streams to; the program
picks its own from ``level``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import reference

STEP_SPAN = "portbench/block_step"
#: Blocks of each judged output on which the level's matcher is held.
SAMPLE_BLOCKS = 8


#: The configuration's keys this entry reads, and those it only carries.
CONFIG_KEYS = {"name", "source", "entry", "framing", "level", "block_size", "segment_index",
               "matcher", "corpus_bytes", "reduced", "source_sizes", "assumed", "guarantees",
               "deployment"}


def check(config: dict) -> None:
    """Raise on what this entry does not implement: an unknown key, a
    framing other than gzip or zlib, a matcher other than the lexicographic
    one the reference works out (``reference.lex_candidates``), at stride 1."""
    unknown = set(config) - CONFIG_KEYS
    if unknown:
        raise ValueError(f"configuration keys the block encode does not read: {sorted(unknown)}")
    if config["framing"] not in ("gzip", "zlib"):
        raise ValueError(f"framing {config['framing']!r}")
    m = config["matcher"]
    if set(m) != {"kind", "wcap", "depth", "keys", "stride"} or m["kind"] != "lex" \
            or m["stride"] != 1:
        raise ValueError(f"matcher {m}: the reference holds only the lex matcher at stride 1")


class BlockEncode:
    def __init__(self, config: dict, device, wrap_step=None):
        from compu_tpu_torch.formats.deflate.options import ZlibMode
        from compu_tpu_torch.kernels.block_codec import make_block_encode_fn
        from compu_tpu_torch.parallel.scheduler import BlockParallelEncoder

        self.framing = config["framing"]
        self.block_size = int(config["block_size"])
        self.matcher = config["matcher"]
        mode = {"gzip": ZlibMode.Gzip, "zlib": ZlibMode.Zlib}[self.framing]
        self.fn = make_block_encode_fn(mode, int(config["level"]),
                                       segment_index=bool(config["segment_index"]),
                                       device=device)
        step = self.fn if wrap_step is None else wrap_step(self.fn)

        def spanned(blocks, lens):
            with torch.profiler.record_function(STEP_SPAN):
                return step(blocks, lens)

        self.enc = BlockParallelEncoder(spanned, block_size=self.block_size, mode=mode)

    def __call__(self, data: bytes):
        """One request: ``((stream, index), host layer times in ms)``."""
        stages = self.enc.metrics.stage_seconds
        before = stages["stage_blocks"] + stages["assemble"]
        out = self.enc.encode(data)
        times = {"framing_ms": 1e3 * (stages["stage_blocks"] + stages["assemble"] - before)}
        last = getattr(self.fn, "last_timings", {})
        for key, name in (("dispatch_ms", "h2d_dispatch_ms"), ("fetch_ms", "payload_d2h_ms")):
            if name in last:
                times[key] = float(last[name])
        return out, times

    @staticmethod
    def out_bytes(out) -> int:
        return len(out[0])

    @staticmethod
    def same(a, b) -> bool:
        """Whether two outputs are the same bytes and the same index."""
        (sa, ia), (sb, ib) = a, b
        if sa != sb:
            return False
        for key in ("raw_lengths", "compressed_offsets", "compressed_lengths"):
            if list(getattr(ia, key)) != list(getattr(ib, key)):
                return False
        ga, gb = ia.segment_bits, ib.segment_bits
        if (ga is None) != (gb is None):
            return False
        return ga is None or (len(ga) == len(gb) and all(
            np.array_equal(x, y) for x, y in zip(ga, gb)))

    def judge(self, data: bytes, out, rng) -> dict:
        """The reference's counts for one output; the level's matcher is
        held on ``SAMPLE_BLOCKS`` of its blocks, drawn by ``rng``."""
        stream, index = out
        nblocks = max(1, -(-len(data) // self.block_size))
        sample = rng.choice(nblocks, min(nblocks, SAMPLE_BLOCKS), replace=False)
        return reference.judge(data, stream, index, mode=self.framing,
                               block_size=self.block_size, matcher=self.matcher,
                               sample=sample.tolist())


def build(config: dict, device, wrap_step=None) -> BlockEncode:
    return BlockEncode(config, device, wrap_step)
