"""Scheduler counters and profiler spans for the port.

``Metrics`` (the port's copy of ``compu_tpu/utils/metrics.py::Metrics``)
aggregates scheduler counters: blocks, raw and compressed bytes, and wall
time per stage. ``trace_span`` marks a host stage in a ``torch.profiler``
trace; outside a trace it costs a few microseconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

__all__ = ["Metrics", "trace_span"]


@dataclasses.dataclass
class Metrics:
    blocks: int = 0
    raw_bytes: int = 0
    compressed_bytes: int = 0
    stage_seconds: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t0

    def record_block(self, raw: int, compressed: int) -> None:
        self.blocks += 1
        self.raw_bytes += raw
        self.compressed_bytes += compressed

    @property
    def ratio(self) -> float:
        return self.raw_bytes / self.compressed_bytes if self.compressed_bytes else 0.0

    def throughput(self, stage: str) -> float:
        """Raw bytes per second through a stage (0 if not timed)."""
        s = self.stage_seconds.get(stage, 0.0)
        return self.raw_bytes / s if s else 0.0

    def summary(self) -> dict:
        return {
            "blocks": self.blocks,
            "raw_bytes": self.raw_bytes,
            "compressed_bytes": self.compressed_bytes,
            "ratio": round(self.ratio, 3),
            "stages_ms": {k: round(v * 1e3, 2) for k, v in self.stage_seconds.items()},
        }


#: ``with trace_span(name):`` — a ``torch.profiler.record_function`` span.
trace_span = torch.profiler.record_function
