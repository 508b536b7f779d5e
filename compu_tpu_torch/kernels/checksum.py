"""Block checksums on the device (plain PyTorch).

Port of ``checksum_jax.crc32_lane_registers``, ``checksum_jax.adler32_block``
and ``deflate_jax_v2._device_crc_register``; ``_block_checksum`` is the
batched checksum of the block encodes. A CRC register is GF(2)-linear in
the input bits, so the registers of all lanes are one product
``bits(lanes, 8c) @ A(8c, 32)`` taken mod 2, and the lane registers fold
pairwise with 32x32 zero-shift operators. The products run in float32 with
TF32 off: entries are 0/1 and counts stay at most 8c <= 2048, so every sum
is exact. The result is the raw (init 0) register of the whole padded
block; the host strips the padding with ``crc_unshift``.
"""

from __future__ import annotations

import contextlib

import torch

from .tables import ADLER_MOD, on_device


@contextlib.contextmanager
def _exact_fp32_matmul():
    """Full float32 products on the card for the duration (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 -> (...) int64 holding the u32 value."""
    w = torch.arange(32, device=bits.device, dtype=torch.int64)
    return (bits.to(torch.int64) << w).sum(-1)


def crc32_lane_registers(blocks: torch.Tensor, lanes: int = 1024) -> torch.Tensor:
    """Raw init-0 CRC registers of ``lanes`` equal contiguous slices of each
    block: (B, n) uint8 -> (B, lanes) int64 u32 values."""
    B, n = blocks.shape
    c = n // lanes
    a = on_device("crc_bit_matrix", blocks.device, c)  # (8c, 32)
    shifts = torch.arange(8, device=blocks.device, dtype=torch.int32)
    grid = blocks.reshape(B * lanes, c, 1).to(torch.int32)
    bits = ((grid >> shifts) & 1).to(torch.float32).reshape(B * lanes, 8 * c)
    with _exact_fp32_matmul():
        acc = bits @ a
    parity = acc.to(torch.int64) & 1
    return _bits_to_u32(parity).reshape(B, lanes)


def device_crc_register(blocks: torch.Tensor) -> torch.Tensor:
    """Raw init-0 CRC register of each whole padded block: (B, N) uint8 ->
    (B,) int64 u32 values. Lane registers, then a GF(2) tree fold where
    level k shifts the even lanes past the odd ones."""
    B, N = blocks.shape
    lanes = 1024
    while lanes > 1 and N % lanes:
        lanes //= 2
    regs = crc32_lane_registers(blocks, lanes=lanes)
    levels = lanes.bit_length() - 1
    mats = on_device("crc_fold_mats", blocks.device, N // lanes, levels)
    w = torch.arange(32, device=blocks.device, dtype=torch.int64)
    bits = ((regs[:, :, None] >> w) & 1).to(torch.float32)  # (B, lanes, 32)
    with _exact_fp32_matmul():
        for k in range(levels):
            even, odd = bits[:, 0::2], bits[:, 1::2]
            shifted = even @ mats[k]
            bits = ((shifted + odd).to(torch.int64) & 1).to(torch.float32)
    return _bits_to_u32(bits[:, 0])


def _block_checksum(datas: torch.Tensor, ns: torch.Tensor, check: str) -> torch.Tensor:
    """(B,) int64 u32: the raw init-0 CRC register of each padded block for
    "crc", the adler32 of its first n bytes for "adler"."""
    if check == "crc":
        return device_crc_register(datas)
    if check != "adler":
        raise ValueError(f"check must be 'crc' or 'adler', got {check!r}")
    B, N = datas.shape
    pos = torch.arange(N, device=datas.device)
    n = ns[:, None]
    db = torch.where(pos < n, datas.to(torch.int64), 0)
    s = db.sum(-1)
    wmod = torch.clamp(n - pos, min=0) % ADLER_MOD
    group = (db * wmod).reshape(B, -1, 64).sum(-1) % ADLER_MOD
    w = group.sum(-1) % ADLER_MOD
    a = (1 + s) % ADLER_MOD
    b = (ns % ADLER_MOD + w) % ADLER_MOD
    return (b << 16) | a


def adler32_block(data: torch.Tensor, n) -> int:
    """adler32 of the first ``n`` bytes of a padded (N,) uint8 block, as an
    int: the single-block form of :func:`_block_checksum`."""
    ns = torch.as_tensor(n, dtype=torch.int64, device=data.device).reshape(1)
    return int(_block_checksum(data[None], ns, "adler")[0])
