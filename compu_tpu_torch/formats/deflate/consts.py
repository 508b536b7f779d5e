"""DEFLATE constants (RFC1951 §3.2.5-3.2.7; the port's copy of
``compu_tpu/formats/deflate/consts.py``)."""

import numpy as np

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768

# Length codes 257..285: (base length, extra bits)
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# Distance codes 0..29: (base distance, extra bits)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int32,
)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# Order in which code-length code lengths are transmitted (RFC1951 §3.2.7).
CLEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)


def _make_length_code_table() -> np.ndarray:
    """LENGTH_CODE[l] for l in 0..258 → litlen symbol (257..285)."""
    table = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    for code in range(len(LENGTH_BASE)):
        base = LENGTH_BASE[code]
        upper = LENGTH_BASE[code + 1] if code + 1 < len(LENGTH_BASE) else MAX_MATCH
        table[base:upper] = 257 + code
    table[MAX_MATCH] = 285  # length 258 has its own code; 284 covers 227..257
    return table


def _make_dist_code_table() -> np.ndarray:
    """DIST_CODE[d] for d in 0..32768 → distance symbol (0..29), d >= 1."""
    table = np.zeros(WINDOW_SIZE + 1, dtype=np.int32)
    for code in range(len(DIST_BASE)):
        base = DIST_BASE[code]
        upper = DIST_BASE[code + 1] if code + 1 < len(DIST_BASE) else WINDOW_SIZE + 1
        table[base:upper] = code
    return table


LENGTH_CODE = _make_length_code_table()
DIST_CODE = _make_dist_code_table()

# Fixed-Huffman code lengths (RFC1951 §3.2.6), the two phantom symbols
# 286 and 287 included.
FIXED_LITLEN_LENGTHS = np.concatenate(
    [
        np.full(144, 8, dtype=np.int64),   # 0..143
        np.full(112, 9, dtype=np.int64),   # 144..255
        np.full(24, 7, dtype=np.int64),    # 256..279
        np.full(8, 8, dtype=np.int64),     # 280..287
    ]
)
FIXED_DIST_LENGTHS = np.full(30, 5, dtype=np.int64)
