"""Optimal length-limited prefix-code lengths (the port's copy of
``compu_tpu/ops/huffman.py::length_limited_lengths``)."""

from __future__ import annotations

import heapq

import numpy as np


def length_limited_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited prefix-code lengths (package-merge).

    ``freqs`` is the full-alphabet frequency array; zero-frequency symbols
    get length 0. A single used symbol gets length 1 (a prefix code must
    still emit one bit, matching zlib's behavior).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    lengths = np.zeros(len(freqs), dtype=np.uint8)
    used = np.nonzero(freqs)[0]
    n = len(used)
    if n == 0:
        return lengths
    if n == 1:
        lengths[used[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError("alphabet cannot fit in max_len bits")
    # Boundary package-merge. Items are (freq, [leaf symbols]); at each of
    # the max_len levels, pair up the previous level and merge with leaves.
    leaves = sorted((int(freqs[s]), [int(s)]) for s in used)
    prev: list[tuple[int, list[int]]] = []
    for _ in range(max_len):
        packages = [
            (
                prev[2 * i][0] + prev[2 * i + 1][0],
                prev[2 * i][1] + prev[2 * i + 1][1],
            )
            for i in range(len(prev) // 2)
        ]
        prev = list(heapq.merge(leaves, packages, key=lambda t: t[0]))
    for _, syms in prev[: 2 * (n - 1)]:
        for s in syms:
            lengths[s] += 1
    return lengths
