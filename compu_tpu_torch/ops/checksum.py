"""Checksum algebra on the host (the port's copy of the part of
``compu_tpu/ops/checksum.py`` it calls).

* adler32 is a pair of modular sums with a closed-form merge of two runs
  (``adler32_combine``).
* crc32 is GF(2)-linear: a register is shifted past n zero bytes by one
  32x32 bit matrix (``zero_shift_operator``), so two runs merge with one
  matrix apply and an XOR (``crc32_combine``), and a register computed on a
  zero-padded block loses its padding by the inverse shift
  (``crc_unshift``).

Matrices are numpy arrays of 32 uint64 rows; row i is the image of basis
vector i.
"""

from __future__ import annotations

import numpy as np

ADLER_MOD = 65521
CRC32_POLY = 0xEDB88320  # reflected polynomial

_BIT_IDX = np.arange(32, dtype=np.uint64)


def _make_crc_table() -> np.ndarray:
    """The classic byte table of the reflected CRC-32."""
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if c & 1 else 0)
        table[i] = c
    return table


CRC_TABLE = _make_crc_table()


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32 of A||B from adler32(A), adler32(B) and len(B) (zlib's
    ``adler32_combine``)."""
    rem = len2 % ADLER_MOD
    a1 = adler1 & 0xFFFF
    b1 = (adler1 >> 16) & 0xFFFF
    a2 = adler2 & 0xFFFF
    b2 = (adler2 >> 16) & 0xFFFF
    a = (a1 + a2 + ADLER_MOD - 1) % ADLER_MOD
    b = (b1 + rem * a1 + b2 + ADLER_MOD - rem) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


def _gf2_apply(mat: np.ndarray, vec: int) -> int:
    """Multiply a 32x32 GF(2) matrix (rows as uint64 bitmasks) by a vector."""
    bits = ((np.uint64(vec) >> _BIT_IDX) & np.uint64(1)).astype(bool)
    return int(np.bitwise_xor.reduce(np.where(bits, mat, np.uint64(0))))


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The operator that applies ``b`` and then ``a``."""
    return np.array([_gf2_apply(a, int(r)) for r in b], dtype=np.uint64)


_SHIFT_CACHE: dict[int, np.ndarray] = {}


def zero_shift_operator(nbytes: int) -> np.ndarray:
    """GF(2) operator advancing a (reflected, LSB-first) CRC register past
    ``nbytes`` zero bytes. Cached per length."""
    op = _SHIFT_CACHE.get(nbytes)
    if op is not None:
        return op
    # One zero bit: shift right with polynomial feedback from bit 0.
    one_bit = np.zeros(32, dtype=np.uint64)
    one_bit[0] = CRC32_POLY
    for i in range(1, 32):
        one_bit[i] = np.uint64(1) << np.uint64(i - 1)
    result = np.array([1 << i for i in range(32)], dtype=np.uint64)
    base = one_bit
    n = nbytes * 8
    while n:
        if n & 1:
            result = _gf2_matmul(base, result)
        n >>= 1
        if n:
            base = _gf2_matmul(base, base)
    _SHIFT_CACHE[nbytes] = result
    return result


def crc_shift(crc: int, nbytes: int) -> int:
    """Shift a raw CRC register past ``nbytes`` zero bytes."""
    if nbytes == 0:
        return crc
    return _gf2_apply(zero_shift_operator(nbytes), crc)


def _gf2_inverse(mat: np.ndarray) -> np.ndarray:
    """Invert a 32x32 GF(2) matrix by Gaussian elimination. Shift operators
    are bijections, so this always succeeds."""
    a = mat.astype(np.uint64).copy()
    inv = np.array([1 << i for i in range(32)], dtype=np.uint64)
    for col in range(32):
        bit = np.uint64(1) << np.uint64(col)
        pivot = next(row for row in range(col, 32) if a[row] & bit)
        a[[col, pivot]] = a[[pivot, col]]
        inv[[col, pivot]] = inv[[pivot, col]]
        for row in range(32):
            if row != col and (a[row] & bit):
                a[row] ^= a[col]
                inv[row] ^= inv[col]
    return inv


_UNSHIFT_CACHE: dict[int, np.ndarray] = {}


def crc_unshift(crc: int, nbytes: int) -> int:
    """Undo ``crc_shift``: the register as it was before ``nbytes``
    trailing zero bytes were appended."""
    if nbytes == 0:
        return crc
    op = _UNSHIFT_CACHE.get(nbytes)
    if op is None:
        op = _UNSHIFT_CACHE[nbytes] = _gf2_inverse(zero_shift_operator(nbytes))
    return _gf2_apply(op, crc)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A||B from the two finished crcs and len(B) (zlib's
    ``crc32_combine``): with finished crcs the conditioning terms cancel to
    ``shift(crc1, len2) ^ crc2``."""
    return (crc_shift(crc1 & 0xFFFFFFFF, len2) ^ crc2) & 0xFFFFFFFF
