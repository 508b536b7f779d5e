"""Brotli constant tables (RFC 7932) and the format's data: the port's
copy of ``compu_tpu/formats/brotli/consts.py``.

``dictionary.bin`` is the 122,784-byte static dictionary and
``context_table.bin`` the 2048-byte context lookup table, both RFC 7932
data (Appendices A and B), read from beside this module.
``transforms_data.py`` holds the 121 word transforms.
"""

from __future__ import annotations

import pathlib

import numpy as np

_HERE = pathlib.Path(__file__).parent

DICTIONARY = _HERE.joinpath("dictionary.bin").read_bytes()
CONTEXT_TABLE = np.frombuffer(_HERE.joinpath("context_table.bin").read_bytes(), dtype=np.uint8)

# Dictionary geometry: NDBITS per word length 0..24 (0 = no words).
DICT_SIZE_BITS = [0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8,
                  7, 7, 8, 7, 7, 6, 6, 5, 5]
DICT_OFFSETS = [0] * 26
for _l in range(25):
    DICT_OFFSETS[_l + 1] = DICT_OFFSETS[_l] + (
        _l * (1 << DICT_SIZE_BITS[_l]) if DICT_SIZE_BITS[_l] else 0
    )
assert DICT_OFFSETS[25] == len(DICTIONARY)

# Code-length-code order and its fixed prefix code (4-bit LSB-first LUT).
CLCODE_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]
CLCODE_LUT_LEN = [2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4]
CLCODE_LUT_VAL = [0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5]

# Block-count code: 26 symbols -> (base, extra bits).
BLOCK_COUNT_BASE = [1, 5, 9, 13, 17, 25, 33, 41, 49, 65, 81, 97, 113, 145,
                    177, 209, 241, 305, 369, 497, 753, 1265, 2289, 4337,
                    8433, 16625]
BLOCK_COUNT_EXTRA = [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6,
                     7, 8, 9, 10, 11, 12, 13, 24]

# Insert-length codes 0..23 -> (base, extra).
INSERT_BASE = [0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98, 130,
               194, 322, 578, 1090, 2114, 6210, 22594]
INSERT_EXTRA = [0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9,
                10, 12, 14, 24]

# Copy-length codes 0..23 -> (base, extra).
COPY_BASE = [2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
             102, 134, 198, 326, 582, 1094, 2118]
COPY_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7,
              8, 9, 10, 24]

# Insert&copy command alphabet: 704 symbols in 64-entry cells.
INSERT_RANGE_LUT = [0, 0, 8, 8, 0, 16, 8, 16, 16]
COPY_RANGE_LUT = [0, 8, 0, 8, 16, 0, 16, 8, 16]

NUM_COMMAND_SYMBOLS = 704
NUM_LITERAL_SYMBOLS = 256
NUM_BLOCK_LEN_SYMBOLS = 26

# Initial distance ring buffer, ordered [last, second, third, fourth].
# RFC 7932 lists the raw buffer slots as {16, 15, 11, 4}, but the reference
# implementation's ring index starts one slot "behind", so the effective
# initial access order is reversed (verified against libbrotli streams).
INITIAL_DISTANCES = [4, 11, 15, 16]
