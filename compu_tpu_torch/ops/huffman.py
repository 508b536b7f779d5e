"""Canonical Huffman pieces (the port's copy of
``compu_tpu/ops/huffman.py``): optimal length-limited code lengths
(``length_limited_lengths``), RFC1951 canonical codes from lengths
(``canonical_codes``) and the flat decode table indexed by the next
LSB-first stream bits (``build_decode_table``), and the Kraft check of a
code's lengths (``validate_lengths``)."""

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


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """RFC1951 §3.2.2 canonical codes (MSB-first integers) from lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    max_bits = int(lengths.max(initial=0))
    codes = np.zeros(len(lengths), dtype=np.uint32)
    if max_bits == 0:
        return codes
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    for sym in range(len(lengths)):
        l = lengths[sym]
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


def build_decode_table(lengths: np.ndarray, max_bits: int):
    """Flat LUT: index = next ``max_bits`` stream bits (LSB-first) ->
    ``(symbol, length)``. Entries for unused indices have length 0 (an
    invalid code). Symbol ``s`` with code ``c`` of length ``l`` owns every
    index whose low ``l`` bits equal ``c`` reversed within ``l`` bits."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = canonical_codes(lengths)
    size = 1 << max_bits
    symbols = np.zeros(size, dtype=np.int32)
    lens = np.zeros(size, dtype=np.uint8)
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        if l > max_bits:
            raise ValueError("code longer than table bits")
        c = int(codes[sym])
        rev = 0
        for _ in range(l):
            rev = (rev << 1) | (c & 1)
            c >>= 1
        idx = np.arange(rev, size, 1 << l)
        symbols[idx] = sym
        lens[idx] = l
    return symbols, lens


def validate_lengths(lengths: np.ndarray) -> bool:
    """Kraft inequality check: a usable prefix code must not oversubscribe;
    foreign streams with oversubscribed trees are corrupt."""
    lengths = np.asarray(lengths, dtype=np.int64)
    used = lengths[lengths > 0]
    if len(used) == 0:
        return True
    kraft = np.sum(2.0 ** (-used.astype(np.float64)))
    return kraft <= 1.0 + 1e-12
