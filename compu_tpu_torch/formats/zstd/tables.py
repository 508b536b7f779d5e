"""Sequence code tables and predefined FSE distributions (RFC 8878
§3.1.1.3.2.1). Literals-length and match-length codes map to
(baseline, extra-bit) pairs; offset codes carry their own bit count.
The port's copy of ``compu_tpu/formats/zstd/tables.py``."""

from __future__ import annotations

import numpy as np

# Literals_Length_Code 0..35 -> (baseline, nbits)
LL_BASE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
     2048, 4096, 8192, 16384, 32768, 65536],
    dtype=np.int64,
)
LL_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64,
)

# Match_Length_Code 0..52 -> (baseline, nbits)
ML_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
     39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
     4099, 8195, 16387, 32771, 65539],
    dtype=np.int64,
)
ML_BITS = np.array(
    [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                13, 14, 15, 16],
    dtype=np.int64,
)

# Predefined FSE distributions (RFC 8878 tables; accuracy logs 6/6/5).
LL_DEFAULT_DIST = [
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1,
]
LL_DEFAULT_LOG = 6

ML_DEFAULT_DIST = [
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1,
]
ML_DEFAULT_LOG = 6

OF_DEFAULT_DIST = [
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1,
]
OF_DEFAULT_LOG = 5

MAX_LL_LOG = 9
MAX_ML_LOG = 9
MAX_OF_LOG = 8

MAX_LL_SYMBOL = 35
MAX_ML_SYMBOL = 52
MAX_OF_SYMBOL = 31


def ll_code(value: int) -> int:
    """Literals length -> code (inverse of LL_BASE)."""
    if value < 16:
        return value
    return int(np.searchsorted(LL_BASE, value, side="right")) - 1


def ml_code(value: int) -> int:
    if value < 35:
        return value - 3
    return int(np.searchsorted(ML_BASE, value, side="right")) - 1
