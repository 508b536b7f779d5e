"""Checksum algebra on the host (the port's copy of the part of
``compu_tpu/ops/checksum.py`` it calls).

* adler32 is a pair of modular sums with a closed-form merge of two runs
  (``adler32_combine``). ``adler32`` calls the host runtime
  (``runtime/native.py``); ``adler32_lanes`` is its numpy twin.
* crc32 is GF(2)-linear: a register is shifted past n zero bytes by one
  32x32 bit matrix (``zero_shift_operator``), so two runs merge with one
  matrix apply and an XOR (``crc32_combine``), and a register computed on a
  zero-padded block loses its padding by the inverse shift
  (``crc_unshift``). ``crc32`` calls the host runtime; ``crc32_lanes`` is
  its twin, the lane-parallel form (slice-by-8 lanes merged by a GF(2)
  tree), and ``fold_lane_registers`` merges the device's lane registers
  the same way.

Matrices are numpy arrays of 32 uint64 rows; row i is the image of basis
vector i.
"""

from __future__ import annotations

import numpy as np

from ..runtime import native

ADLER_MOD = 65521
CRC32_POLY = 0xEDB88320  # reflected polynomial

_BIT_IDX = np.arange(32, dtype=np.uint64)


def _make_crc_tables(n: int = 8) -> np.ndarray:
    """Slice-by-n tables: T[0] is the classic byte table of the reflected
    CRC-32; T[k] advances a byte seen k positions earlier past k zero
    bytes."""
    tables = np.zeros((n, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if c & 1 else 0)
        tables[0, i] = c
    for k in range(1, n):
        prev = tables[k - 1]
        tables[k] = tables[0][prev & 0xFF] ^ (prev >> 8)
    return tables


CRC_TABLES = _make_crc_tables()
CRC_TABLE = CRC_TABLES[0]


def adler32(data, value: int = 1) -> int:
    """adler32 of ``data`` continuing from ``value`` (``zlib.adler32``), in
    the host runtime."""
    return native.adler32(data, value)


def adler32_lanes(data, value: int = 1) -> int:
    """The numpy twin of ``adler32``: a sum and a weighted sum a 64 KiB
    chunk, exact in float64 (the weighted sum stays below 2^53), merged in
    int64."""
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    step = 1 << 16
    m = (len(arr) // step) * step
    if m:
        grid = arr[:m].reshape(-1, step).astype(np.float64)
        weights = np.arange(step, 0, -1, dtype=np.float64)
        s = grid.sum(axis=1).astype(np.int64)
        w = (grid @ weights).astype(np.int64)
        # a before chunk k, reduced first so that b's sum stays in int64
        a_prefix = (a + np.concatenate([[0], np.cumsum(s)[:-1]])) % ADLER_MOD
        b = int((b + np.sum(step * a_prefix + w)) % ADLER_MOD)
        a = int((a + s.sum()) % ADLER_MOD)
    tail = arr[m:]
    if len(tail):
        n = len(tail)
        chunk = tail.astype(np.float64)
        s_t = int(chunk.sum())
        w_t = int(np.dot(chunk, np.arange(n, 0, -1, dtype=np.float64)))
        b = (b + n * a + w_t) % ADLER_MOD
        a = (a + s_t) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


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


def _gf2_apply_vec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Apply one 32x32 GF(2) operator to many registers at once."""
    bits = (vec[:, None].astype(np.uint64) >> _BIT_IDX[None, :]) & np.uint64(1)
    return np.bitwise_xor.reduce(bits * mat[None, :], axis=1).astype(np.uint32)


def _crc_serial(reg: int, data: np.ndarray) -> int:
    """Raw register update over a short byte array, a byte at a time."""
    crcs = np.array([reg], dtype=np.uint32)
    for byte in data:
        crcs = CRC_TABLE[(crcs ^ byte) & 0xFF] ^ (crcs >> 8)
    return int(crcs[0])


def _crc_lanes_slice8(grid: np.ndarray) -> np.ndarray:
    """Raw CRC register (init 0) of each row of a (L, c) uint8 array, c a
    multiple of 8, all rows advancing together (slice-by-8)."""
    crcs = np.zeros(grid.shape[0], dtype=np.uint32)
    g = grid.astype(np.uint32)
    t0, t1, t2, t3, t4, t5, t6, t7 = CRC_TABLES
    for j in range(0, grid.shape[1], 8):
        x = crcs ^ (g[:, j] | (g[:, j + 1] << 8) | (g[:, j + 2] << 16) | (g[:, j + 3] << 24))
        crcs = (t7[x & 0xFF] ^ t6[(x >> 8) & 0xFF] ^ t5[(x >> 16) & 0xFF] ^ t4[(x >> 24) & 0xFF]
                ^ t3[g[:, j + 4]] ^ t2[g[:, j + 5]] ^ t1[g[:, j + 6]] ^ t0[g[:, j + 7]])
    return crcs


def crc32(data, value: int = 0) -> int:
    """crc32 with gzip conventions, continuing from ``value``
    (``zlib.crc32``), in the host runtime."""
    return native.crc32(data, value)


def crc32_lanes(data, value: int = 0) -> int:
    """The twin of ``crc32``, the reference's lane-parallel form: below 16 KiB a byte at a time;
    above, L contiguous lanes advance together (slice-by-8) and their
    registers merge with a log2(L)-level GF(2) tree (each level shifts the
    left half past the right half's length and XORs)."""
    data = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(data)
    reg = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n == 0:
        return value & 0xFFFFFFFF
    if n < 1 << 14:
        return (_crc_serial(reg, data) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    lanes = 1 << max(6, min(13, (n // 8192).bit_length()))
    c = (n // lanes) & ~7  # bytes a lane, a multiple of 8
    body = lanes * c
    vals = _crc_lanes_slice8(data[:body].reshape(lanes, c))
    op = zero_shift_operator(c)
    while len(vals) > 1:
        vals = _gf2_apply_vec(op, vals[0::2]) ^ vals[1::2]
        op = _gf2_matmul(op, op)
    r = crc_shift(reg, body) ^ int(vals[0])
    if body < n:
        r = _crc_serial(r, data[body:])
    return (r ^ 0xFFFFFFFF) & 0xFFFFFFFF


def fold_lane_registers(lane_regs: np.ndarray, lane_bytes: int,
                        init_reg: int = 0xFFFFFFFF) -> int:
    """Merge raw lane CRC registers (init 0, contiguous lanes of
    ``lane_bytes`` each, a power-of-two count) into the stream register,
    folding in ``init_reg`` at the front: the host half of the device's
    lane-parallel crc32."""
    vals = np.asarray(lane_regs).astype(np.uint32)
    op = zero_shift_operator(lane_bytes)
    while len(vals) > 1:
        if len(vals) % 2:
            raise ValueError("lane count must be a power of two")
        vals = _gf2_apply_vec(op, vals[0::2]) ^ vals[1::2]
        op = _gf2_matmul(op, op)
    return int(crc_shift(init_reg, lane_bytes * len(lane_regs)) ^ int(vals[0]))
