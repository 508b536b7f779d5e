"""The v1 block encode: the chain-walk matcher and fixed-Huffman blocks.

Port of ``compu_tpu/kernels/deflate_jax.py``, in plain PyTorch on the
blocks' device (the reference's is a jitted ``jax.lax`` graph, no Pallas
kernel). A (B, N) batch of padded blocks runs as one set of (B, N)
tensors:

    hash3 -> chain build (stable sort) -> chain walk with 4-byte XOR match
    measurement -> lazy demote -> pointer-doubling greedy cover ->
    fixed-Huffman code mapping -> prefix-sum bit offsets -> scatter-add
    bit packing -> sync-flush byte alignment, plus the block's adler32.

Each block is an RFC 1951 raw-deflate run ending in an empty non-final
stored block (Z_SYNC_FLUSH), so it is byte-aligned and decodes on its own;
matches stay inside the block. Bit packing partitions the output bits, so
the scatter-add is a scatter-OR. A block's bytes and ``meta = [out_len,
adler32]`` equal the reference's: the lanes of other blocks and the
positions that are no longer active never change a block's result.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.deflate import consts
from ..ops.bitio import reverse_bits
from ..ops.huffman import canonical_codes
from . import u32
from .tables import ADLER_MOD, to_torch

HASH_MUL = 2654435761


def _rev_codes(lengths: np.ndarray) -> np.ndarray:
    return reverse_bits(canonical_codes(lengths), lengths.astype(np.uint32)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The fixed codes (bit-reversed, LSB-first) and the length/distance
    symbol tables, uploaded once per device."""
    return to_torch({
        "lit_len": consts.FIXED_LITLEN_LENGTHS.astype(np.int64),
        "lit_rev": _rev_codes(consts.FIXED_LITLEN_LENGTHS),
        "dist_len": consts.FIXED_DIST_LENGTHS.astype(np.int64),
        "dist_rev": _rev_codes(consts.FIXED_DIST_LENGTHS),
        "length_code": consts.LENGTH_CODE.astype(np.int64),
        "length_base": consts.LENGTH_BASE.astype(np.int64),
        "length_extra": consts.LENGTH_EXTRA.astype(np.int64),
        "dist_code": consts.DIST_CODE.astype(np.int64),
        "dist_base": consts.DIST_BASE.astype(np.int64),
        "dist_extra": consts.DIST_EXTRA.astype(np.int64),
    }, device)


def _u32_view(data: torch.Tensor, pad: int) -> torch.Tensor:
    """u32[..., i] = little-endian 4 bytes at i, zero-padded past the end:
    (B, N) uint8 -> (B, N + pad - 3) int64."""
    u = F.pad(data, (0, pad)).to(torch.int64)
    return u[:, :-3] | (u[:, 1:-2] << 8) | (u[:, 2:-1] << 16) | (u[:, 3:] << 24)


def _match_lengths_dense(u32v: torch.Tensor, pos: torch.Tensor, cand: torch.Tensor,
                         limit: torch.Tensor, active0: torch.Tensor) -> torch.Tensor:
    """Common-prefix lengths of the words at ``pos`` and ``cand`` by 4-byte
    XOR steps, capped at ``limit``: (B, M) each. The reference's while
    loop over dense masks becomes a loop over the still-active lanes,
    which it leaves as soon as no lane is active; an inactive lane's
    length is ``min(0, limit)``."""
    B, W = u32v.shape
    flat = u32v.reshape(-1)
    row = (torch.arange(B, device=pos.device, dtype=torch.int64) * W)[:, None].expand_as(pos)
    pos_f, cand_f, lim_f, row_f = (x.reshape(-1) for x in (pos, cand, limit, row))
    lens = torch.zeros(pos.numel(), dtype=torch.int64, device=pos.device)
    idx = active0.reshape(-1).nonzero().squeeze(1)
    while idx.numel():
        ln = lens[idx]
        ai = torch.clamp(pos_f[idx] + ln, 0, W - 1) + row_f[idx]
        bi = torch.clamp(cand_f[idx] + ln, 0, W - 1) + row_f[idx]
        x = flat[ai] ^ flat[bi]
        # Equal low bytes: the trailing zero bytes of the XOR (4 if all).
        cnt = ((x & 0xFF) == 0).to(torch.int64) + ((x & 0xFFFF) == 0) \
            + ((x & 0xFFFFFF) == 0) + (x == 0)
        ln = ln + cnt
        lens[idx] = ln
        idx = idx[(cnt == 4) & (ln < lim_f[idx])]
    return torch.minimum(lens.reshape(pos.shape), limit)


def encode_blocks_fixed(blocks: torch.Tensor, lens: torch.Tensor, *, depth: int = 8,
                        nice: int = 128, lazy: bool = True, cap: int = 0):
    """Encode a batch of padded blocks as fixed-Huffman deflate.

    Args:
      blocks: (B, N) uint8 padded blocks (bytes past a block's length are
        ignored).
      lens: (B,) the blocks' lengths, each > 0.
      depth/nice/lazy: match-finder effort (the level ladder's).
      cap: output capacity in bytes; 0 means N + N//2 + 64.

    Returns (outs (B, cap) uint8, metas (B, 2) int32 = [out_len, adler32
    as int32 bits]). Bytes of ``outs`` past a block's ``out_len`` are 0."""
    B, N = blocks.shape
    dev = blocks.device
    t = _tables(dev)
    if cap == 0:
        cap = N + N // 2 + 64
    pos = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    n = torch.as_tensor(lens, device=dev).to(torch.int64)[:, None]
    in_range = pos < n

    # --- hash chains -----------------------------------------------------
    d0 = blocks.to(torch.int64)
    v = d0 | (torch.roll(d0, -1, -1) << 8) | (torch.roll(d0, -2, -1) << 16)
    h = ((v * HASH_MUL) & u32.MASK32) >> 16
    # Positions past n-2 must not form matches: give them unique hashes.
    h = torch.where(pos < n - 2, h, 0x10000 + pos)
    h_sorted, order = torch.sort(h, dim=-1, stable=True)
    same = F.pad(h_sorted[:, 1:] == h_sorted[:, :-1], (1, 0))
    prev_sorted = torch.where(same, torch.roll(order, 1, -1), -1)
    prev = torch.empty_like(order).scatter_(1, order, prev_sorted)

    # --- chain walk with match measurement -------------------------------
    u32v = _u32_view(blocks, consts.MAX_MATCH + 8)
    # Measuring beyond ``nice`` wastes rounds: matches are accepted at nice
    # length anyway, so the measured length is capped.
    max_measure = min(consts.MAX_MATCH, max(nice, 16))
    limit = torch.clamp(n - pos, max=max_measure)
    best_len = torch.zeros(B, N, dtype=torch.int64, device=dev)
    best_dist = torch.zeros(B, N, dtype=torch.int64, device=dev)
    cand = prev
    for _ in range(depth):
        valid = (cand >= 0) & (pos - cand <= consts.WINDOW_SIZE) & in_range
        active = valid & (best_len < nice)
        ln = _match_lengths_dense(u32v, pos.expand(B, N), torch.clamp(cand, min=0), limit,
                                  active)
        better = active & (ln > best_len)
        best_len = torch.where(better, ln, best_len)
        best_dist = torch.where(better, pos - cand, best_dist)
        cand = torch.where(cand >= 0, prev.gather(1, torch.clamp(cand, min=0)), -1)

    # --- heuristics (zlib-compatible) ------------------------------------
    drop = (best_len == consts.MIN_MATCH) & (best_dist > 4096)
    best_len = torch.where(drop, 0, best_len)
    if lazy:
        nxt_len = F.pad(best_len[:, 1:], (0, 1))
        best_len = torch.where(nxt_len > best_len, 0, best_len)
    take = best_len >= consts.MIN_MATCH

    # --- greedy cover via pointer doubling -------------------------------
    # After k rounds the path's first 2^k tokens are marked and the jump
    # table advances 2^k tokens.
    step = torch.where(take, best_len, 1)
    jump = F.pad(torch.clamp(pos + step, max=N), (0, 1), value=N)  # (B, N+1)
    on_path = torch.zeros(B, N + 1, dtype=torch.int64, device=dev)
    on_path[:, 0] = 1
    for _ in range(max(1, math.ceil(math.log2(max(N, 2)))) + 1):
        hit = torch.zeros_like(on_path).scatter_add_(1, torch.where(on_path > 0, jump, N), on_path)
        on_path = ((on_path + hit) > 0).to(torch.int64)
        jump = jump.gather(1, jump)
    is_tok = (on_path[:, :N] > 0) & in_range

    # --- fixed-Huffman field mapping -------------------------------------
    is_match_tok = is_tok & take
    is_lit_tok = is_tok & ~take
    mlen = torch.clamp(best_len, consts.MIN_MATCH, consts.MAX_MATCH)
    lsym = t["length_code"][mlen]
    lsym_idx = lsym - 257
    lcode_bits = t["lit_len"][lsym]
    lextra_bits = t["length_extra"][lsym_idx]
    lextra_val = mlen - t["length_base"][lsym_idx]
    dclip = torch.clamp(best_dist, 1, consts.WINDOW_SIZE)
    dsym = t["dist_code"][dclip]
    dcode_bits = t["dist_len"][dsym]
    dextra_bits = t["dist_extra"][dsym]
    dextra_val = dclip - t["dist_base"][dsym]
    lit = blocks.to(torch.int64)

    # Field 0 per position: literal code or length (code | extra).
    f0_val = torch.where(is_match_tok, t["lit_rev"][lsym] | (lextra_val << lcode_bits),
                         t["lit_rev"][lit])
    f0_bits = torch.where(is_match_tok, lcode_bits + lextra_bits,
                          torch.where(is_lit_tok, t["lit_len"][lit], 0))
    f0_bits = torch.where(is_tok, f0_bits, 0)
    # Field 1 per position: distance (code | extra) for matches.
    f1_val = t["dist_rev"][dsym] | (dextra_val << dcode_bits)
    f1_bits = torch.where(is_match_tok, dcode_bits + dextra_bits, 0)

    # --- assemble the bit stream -----------------------------------------
    # Layout: [bfinal=0, btype=01] + fields, position-major (f0 then f1 per
    # position) + EOB + the sync flush's empty stored block.
    eob_val, eob_bits = int(t["lit_rev"][256]), int(t["lit_len"][256])
    base = F.pad(torch.cumsum(f0_bits + f1_bits, 1), (1, 0))  # (B, N+1)
    off_f0 = 3 + base[:, :N]
    off_eob = 3 + base[:, N:]
    col = lambda x: torch.full((B, 1), x, dtype=torch.int64, device=dev)  # noqa: E731
    vals = torch.cat([col(0 | (1 << 1)), f0_val, f1_val, col(eob_val)], 1)
    bits = torch.cat([col(3), f0_bits, f1_bits, col(eob_bits)], 1)
    offsets = torch.cat([col(0), off_f0, off_f0 + f0_bits, off_eob], 1)
    total_bits = off_eob[:, 0] + eob_bits
    # The empty stored block's 3 zero header bits, then its own byte align.
    total_bytes = (total_bits + 3 + 7) // 8
    shifted = vals << (offsets % 8)
    bytepos = offsets // 8
    valid = bits > 0
    out = torch.zeros(B, cap, dtype=torch.int64, device=dev)
    # A field holds at most 18 bits (distance code + extra), 25 once
    # shifted: four bytes.
    for k in range(4):
        contrib = torch.where(valid, (shifted >> (8 * k)) & 0xFF, 0)
        idx = torch.clamp(torch.where(valid, bytepos + k, cap - 1), 0, cap - 1)
        out.scatter_add_(1, idx, contrib)
    # Stored-block LEN/NLEN at the aligned position.
    sync = torch.tensor([0, 0, 0xFF, 0xFF], dtype=torch.int64, device=dev)
    out.scatter_(1, total_bytes[:, None] + torch.arange(4, device=dev), sync.expand(B, 4))
    out_len = total_bytes + 4

    # --- adler32 of the block --------------------------------------------
    db = torch.where(in_range, d0, 0)
    s = db.sum(1)
    w = (db * (torch.clamp(n - pos, min=0) % ADLER_MOD)).sum(1) % ADLER_MOD
    a = (1 + s) % ADLER_MOD
    b = (n[:, 0] % ADLER_MOD + w) % ADLER_MOD
    adler = (b << 16) | a
    metas = torch.stack([out_len.to(torch.int32), u32.to_i32_bits(adler)], 1)
    return out.to(torch.uint8), metas


def encode_block_fixed(data: torch.Tensor, n, *, depth: int = 8, nice: int = 128,
                       lazy: bool = True, cap: int = 0):
    """One padded block (N,) uint8 of length ``n``: (out (cap,) uint8,
    meta (2,) int32), the reference's ``encode_block_fixed``."""
    outs, metas = encode_blocks_fixed(data[None], torch.as_tensor([int(n)]), depth=depth,
                                      nice=nice, lazy=lazy, cap=cap)
    return outs[0], metas[0]
