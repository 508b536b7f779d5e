"""What the traced run reads from torch.profiler: the card's kernels and
copies in the window, the host's spans and operations, and the idle gaps
between the card's work with what the host was doing in each.

The window of a trace runs from the start of its first request span
(``portbench/request``) to the end of its last. Busy time is the union of
the card's kernels and copies inside it; a gap is a stretch of the window
with neither, and is named after the benchmark span it falls in
(``request``, ``block_step``) and the innermost host event running at its
middle (``no_op`` where none is).
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np
import torch

REQUEST_SPAN = "portbench/request"
SPANS = {REQUEST_SPAN: "request", "portbench/block_step": "block_step"}
NAME_CHARS = 64  # breakdown names are cut to this many characters


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(1e3 * getattr(e, f"{what}_us")())


def merge(start: np.ndarray, end: np.ndarray):
    """The union of intervals as sorted, disjoint (starts, ends)."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], np.maximum.accumulate(end[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], e[last]


class Trace:
    """The device and host events of one traced window, in ns."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        dev, host, req = [], [], []
        for e in events:
            name, start = e.name(), _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((name, start, end))
            elif name == REQUEST_SPAN:
                req.append((start, end, e.start_thread_id()))
            else:
                host.append((name, start, end, e.start_thread_id()))
        self.n_requests = len(req)
        if req:
            self.t0 = min(r[0] for r in req)
            self.t1 = max(r[1] for r in req)
            tid = req[0][2]
        else:
            self.t0 = self.t1 = 0
            tid = None
        self.window_ns = self.t1 - self.t0
        dev = [d for d in dev if self.t0 <= d[1] < self.t1]
        self.names = [d[0] for d in dev]
        self.start = np.asarray([d[1] for d in dev], np.int64)
        self.end = np.asarray([d[2] for d in dev], np.int64)
        self.is_copy = np.asarray([n.startswith(("Memcpy", "Memset")) for n in self.names], bool)
        bs, be = merge(self.start, np.minimum(self.end, self.t1))
        self.busy_ns = int((be - bs).sum())
        # Host events of the request thread, outermost first at equal starts.
        host = [(h[1], -h[2], h[0]) for h in host if h[3] == tid]
        host += [(r[0], -r[1], REQUEST_SPAN) for r in req]
        host.sort()
        self._hs = np.asarray([h[0] for h in host], np.int64)
        self._he = np.asarray([-h[1] for h in host], np.int64)
        self._hn = [h[2] for h in host]
        self._parent = self._nesting()
        gs = np.append(self.t0, be)
        ge = np.append(bs, self.t1)
        keep = ge > gs
        self.gap_start, self.gap_end = gs[keep], ge[keep]

    @property
    def window_s(self) -> float:
        return self.window_ns * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def _nesting(self) -> np.ndarray:
        parent = np.full(len(self._hn), -1, np.int64)
        stack: list[int] = []
        for i, s in enumerate(self._hs.tolist()):
            while stack and self._he[stack[-1]] <= s:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        return parent

    def _climb(self, idx: np.ndarray, stop) -> np.ndarray:
        """From each event, up its parents until ``stop(events, lanes)``
        holds (-1: none)."""
        idx = idx.copy()
        while True:
            lanes = np.nonzero(idx >= 0)[0]
            move = lanes[~stop(idx[lanes], lanes)]
            if move.size == 0:
                return idx
            idx[move] = self._parent[idx[move]]

    def gap_labels(self) -> list[str]:
        """Each gap's name: ``<benchmark span>: <innermost host event>``."""
        if not self._hn or self.gap_start.size == 0:
            return ["outside: no_op"] * self.gap_start.size
        mid = (self.gap_start + self.gap_end) // 2
        idx = np.searchsorted(self._hs, mid, side="right") - 1
        inner = self._climb(idx, lambda ev, lanes: self._he[ev] > mid[lanes])
        ours = np.asarray([n in SPANS for n in self._hn], bool)
        span = self._climb(inner, lambda ev, lanes: ours[ev])
        out = []
        for i, s in zip(inner.tolist(), span.tolist()):
            op = "no_op" if i < 0 or self._hn[i] in SPANS else self._hn[i]
            out.append(f"{SPANS[self._hn[s]] if s >= 0 else 'outside'}: {op}")
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for n, d in zip(self.names, (self.end - self.start).tolist()):
            ops[n[:NAME_CHARS]] += d * 1e-9
        gaps = defaultdict(float)
        for n, d in zip(self.gap_labels(), (self.gap_end - self.gap_start).tolist()):
            gaps[n[:NAME_CHARS]] += d * 1e-9
        return {"device_ops": sorted(map(list, ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(map(list, gaps.items()), key=lambda x: -x[1])[:top]}


def kernel_names_in(sources) -> set[str]:
    """The ``__global__`` functions defined in CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    return {m.group(1) for src in sources for m in pat.finditer(src.read_text())}


def calls(names: list[str], wanted: set[str]) -> np.ndarray:
    """Which device events are calls of one of ``wanted`` (a name's
    identifiers, as the profiler demangles it, include it)."""
    return np.asarray([not wanted.isdisjoint(re.findall(r"\w+", n)) for n in names], bool)
