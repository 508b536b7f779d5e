"""Constant tables shared with the JAX reference, rebuilt in numpy.

The encode has no weights; besides the input blocks, the state both
packages must agree on is these tables. They are rebuilt here from the
port's own ``ops/checksum.py``, and the tests hold them equal to the
reference's arrays:

* ``FIXED_LIT_LEN_NP``, ``FIXED_DIST_LEN_NP``, ``CL_ORDER`` — RFC1951
  fixed-tree code lengths and the code-length-code order
  (``deflate_jax_v3.py``);
* ``ADLER_MOD`` (``deflate_jax.py``);
* ``crc_bit_matrix(c)`` — the CRC register contribution of every input bit
  of a c-byte lane (``checksum_jax._crc_bit_matrix``);
* ``crc_fold_mats(lane_bytes, levels)`` — the GF(2) operators that shift a
  register past lane_bytes * 2^k zero bytes (``deflate_jax_v2._crc_fold_mats``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.checksum import (
    ADLER_MOD,
    CRC_TABLE,
    _gf2_matmul,
    zero_shift_operator,
)

__all__ = ["ADLER_MOD", "CL_ORDER", "FIXED_DIST_LEN_NP", "FIXED_LIT_LEN_NP",
           "NDIST", "NLIT", "crc_bit_matrix", "crc_fold_mats", "on_device", "to_torch"]

NLIT = 286
NDIST = 30
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

FIXED_LIT_LEN_NP = np.zeros(NLIT, dtype=np.int32)
FIXED_LIT_LEN_NP[:144] = 8
FIXED_LIT_LEN_NP[144:256] = 9
FIXED_LIT_LEN_NP[256:280] = 7
FIXED_LIT_LEN_NP[280:286] = 8
FIXED_DIST_LEN_NP = np.full(NDIST, 5, dtype=np.int32)


@functools.lru_cache(maxsize=8)
def crc_bit_matrix(c: int) -> np.ndarray:
    """A[8c, 32] float32: A[8p+b, k] = bit k of the raw (init 0) CRC
    register of a c-byte buffer whose only set bit is bit b of byte p.
    All 8c unit buffers advance through the byte table together."""
    nbits = 8 * c
    regs = np.zeros(nbits, dtype=np.uint32)
    for p in range(c):
        byte = np.zeros(nbits, dtype=np.uint32)
        j = 8 * p + np.arange(8)
        byte[j] = 1 << np.arange(8)
        regs = CRC_TABLE[(regs ^ byte) & 0xFF] ^ (regs >> 8)
    return ((regs[:, None] >> np.arange(32)[None, :]) & 1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def crc_fold_mats(lane_bytes: int, levels: int) -> np.ndarray:
    """(levels, 32, 32) float32 GF(2) operators: level k shifts a register
    past lane_bytes * 2^k zero bytes. M[i, j] = bit j of the image of
    basis vector i."""
    op = zero_shift_operator(lane_bytes)
    mats = np.zeros((levels, 32, 32), dtype=np.float32)
    for k in range(levels):
        for i in range(32):
            mats[k, i] = (int(op[i]) >> np.arange(32)) & 1
        op = _gf2_matmul(op, op)
    return mats


def to_torch(tables_np: dict, device) -> dict:
    """The same tables as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tables_np.items()}


# The encode's constant tensors, by name; the crc tables take their sizes.
_ON_DEVICE = {
    "fixed_lit": lambda: FIXED_LIT_LEN_NP.astype(np.int64),
    # The full 288-symbol fixed tree (codes 286/287 shift the 9-bit first code).
    "fixed_lit288": lambda: np.concatenate([FIXED_LIT_LEN_NP, [8, 8]]).astype(np.int64),
    "fixed_dist": lambda: FIXED_DIST_LEN_NP.astype(np.int64),
    "cl_order": lambda: CL_ORDER.astype(np.int64),
    "ln2_f32": lambda: np.array(np.log(2), np.float32),
    # Z_SYNC_FLUSH: an empty stored block (LEN=0, NLEN=FFFF); after a
    # stored block its 3 header bits take a byte of their own.
    "sync_flush": lambda: np.array([0, 0, 0xFF, 0xFF], np.int64),
    "stored_sync_flush": lambda: np.array([0, 0, 0, 0xFF, 0xFF], np.int64),
    "crc_bit_matrix": crc_bit_matrix,
    "crc_fold_mats": crc_fold_mats,
}


@functools.lru_cache(maxsize=None)
def on_device(name: str, device: torch.device, *args) -> torch.Tensor:
    """The constant table ``name`` as a tensor on ``device``, uploaded once
    per device and then shared, so an encode uploads only its blocks.
    Callers must not write to it."""
    return to_torch({name: _ON_DEVICE[name](*args)}, device)[name]
