"""XXH64, the zstd content checksum: ``xxh64`` calls the host runtime
(``runtime/native.py``), and ``xxh64_py`` is its pure-Python twin (the
port's copy of ``compu_tpu/ops/xxhash.py``).

The stripe chain is sequential: each 32-byte stripe folds into four
rotating accumulators. Spec: https://github.com/Cyan4973/xxHash (XXH64).
"""

from __future__ import annotations

import struct

from ..runtime import native

P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5
MASK = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * P2) & MASK, 31) * P1) & MASK


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return ((acc * P1) + P4) & MASK


def xxh64(data: bytes, seed: int = 0) -> int:
    return native.xxh64(data, seed)


def xxh64_py(data: bytes, seed: int = 0) -> int:
    n = len(data)
    if n >= 32:
        v1 = (seed + P1 + P2) & MASK
        v2 = (seed + P2) & MASK
        v3 = seed & MASK
        v4 = (seed - P1) & MASK
        nstripes = n // 32
        lanes = struct.unpack_from("<%dQ" % (nstripes * 4), data)
        for i in range(0, nstripes * 4, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & MASK
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
        pos = nstripes * 32
    else:
        h = (seed + P5) & MASK
        pos = 0
    h = (h + n) & MASK
    while pos + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, pos)
        h ^= _round(0, k)
        h = (_rotl(h, 27) * P1 + P4) & MASK
        pos += 8
    if pos + 4 <= n:
        (k,) = struct.unpack_from("<I", data, pos)
        h ^= (k * P1) & MASK
        h = (_rotl(h, 23) * P2 + P3) & MASK
        pos += 4
    while pos < n:
        h ^= (data[pos] * P5) & MASK
        h = (_rotl(h, 11) * P1) & MASK
        pos += 1
    h ^= h >> 33
    h = (h * P2) & MASK
    h ^= h >> 29
    h = (h * P3) & MASK
    h ^= h >> 32
    return h

