"""DEFLATE block encode with per-block dynamic Huffman trees, fixed-tree
fallback and stored blocks, on the device.

Port of ``compu_tpu/kernels/deflate_jax_v3.py``. Blocks are a leading
dimension everywhere (the reference vmaps and lax.maps over them). The
TPU's one-hot matrix-product tricks become what a GPU does directly:
histograms are scatter-adds, table lookups are gathers, and the coarse
placement of segment rows into the output is one scatter-add. The per-block
trees and header are kernel P5 (``build_tables``), the packing of fields
into segment rows the ``emit_pack`` kernel. Output bytes,
metas ``[len, check]`` and ``seg_bits`` equal the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats.deflate import consts

from . import u32
# build_lengths and canonical_codes are imported from here too.
from .build_tables import build_lengths, build_tables, canonical_codes  # noqa: F401
from .checksum import _block_checksum
from .deflate_v2 import SEG, cover_overflow, match_and_parse_batch
from .emit_pack import W2, emit_pack
from .tables import NDIST, NLIT, on_device

W_SLACK = 256  # output-buffer slack past cap


# ---------------------------------------------------------------------------
# Token stage: symbols + histograms
# ---------------------------------------------------------------------------

def _token_syms(data, mlen, dclip):
    """Length/dist symbol decomposition (closed form, RFC1951 §3.2.5)."""
    m = mlen - consts.MIN_MATCH
    e_l = ((m >= 8).to(torch.int64) + (m >= 16) + (m >= 32) + (m >= 64)
           + (m >= 128))
    lsym = 257 + (e_l << 2) + (m >> e_l)
    lextra = m & ((1 << e_l) - 1)
    is258 = mlen == consts.MAX_MATCH
    lsym = torch.where(is258, 285, lsym)
    e_l = torch.where(is258, 0, e_l)
    lextra = torch.where(is258, 0, lextra)

    ds = dclip - 1
    e_d = (ds >= 4).to(torch.int64)
    for k in range(3, 15):
        e_d = e_d + (ds >= (1 << k))
    dsym = torch.where(ds < 2, ds, 2 * (e_d + 1) + ((ds >> e_d) & 1))
    dextra = ds & ((1 << e_d) - 1)
    return lsym, e_l, lextra, dsym, e_d, dextra


def _stored_block(datas: torch.Tensor, ns: torch.Tensor, cap: int):
    """Stored-block emission: ceil(n/65535) chunks of a 5-byte header plus
    raw bytes. Returns ((B, cap) int64 buffer, (B,) byte count)."""
    B, N = datas.shape
    CH = 65535
    pieces = []
    for c in range(-(-N // CH)):
        take = torch.clamp(ns - c * CH, 0, CH)
        nlen = take ^ 0xFFFF
        pieces.append(torch.stack([torch.zeros_like(take), take & 0xFF,
                                   (take >> 8) & 0xFF, nlen & 0xFF,
                                   (nlen >> 8) & 0xFF], -1))
        pieces.append(datas[:, c * CH:(c + 1) * CH].to(torch.int64))
    buf = torch.cat(pieces, -1)
    buf = F.pad(buf, (0, cap - buf.shape[1]))
    total = ns + 5 * ((ns + CH - 1) // CH)
    j = torch.arange(cap, device=datas.device)
    return torch.where(j < total[:, None], buf, 0), total


def _tok_hist_from_match(datas, ns, is_tok, best_len, best_dist):
    """Token symbols and per-block histograms from the cover."""
    B = datas.shape[0]
    dev = datas.device
    take = best_len >= consts.MIN_MATCH
    is_match = is_tok & take
    is_lit = is_tok & ~take
    mlen = torch.clamp(best_len, consts.MIN_MATCH, consts.MAX_MATCH)
    dclip = torch.clamp(best_dist, 1, consts.WINDOW_SIZE)
    lsym, e_l, lextra, dsym, e_d, dextra = _token_syms(datas, mlen, dclip)
    sym = torch.where(is_match, lsym, datas.to(torch.int64))
    lit_freq = torch.zeros(B, NLIT, dtype=torch.int64, device=dev).scatter_add_(
        1, sym, is_tok.to(torch.int64))
    lit_freq[:, 256] += 1  # EOB
    dist_freq = torch.zeros(B, NDIST, dtype=torch.int64, device=dev).scatter_add_(
        1, dsym, is_match.to(torch.int64))
    extra_l_bits = torch.where(is_match, e_l, 0).sum(-1)
    extra_d_bits = torch.where(is_match, e_d, 0).sum(-1)
    tok = dict(is_match=is_match, is_lit=is_lit, sym=sym, e_l=e_l,
               lextra=lextra, dsym=dsym, e_d=e_d, dextra=dextra,
               ov=cover_overflow(is_tok, best_len))
    return tok, lit_freq, dist_freq, extra_l_bits, extra_d_bits


def _build_tables(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns):
    """Trees, header fields and the block-type choice, per block: kernel P5
    on CUDA, its plain version on the CPU (``build_tables``)."""
    return build_tables(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns)


# ---------------------------------------------------------------------------
# Emit
# ---------------------------------------------------------------------------

def _pack_inputs(tok, tables, N: int):
    """Field values and bit offsets of every token, cut into segment rows.

    Returns ``(bytep, shifted, seg_bit0, off_eob)``: (B*S, 2*SEG) int32 row
    byte positions and u32 bit patterns — the input of ``emit_pack`` — the
    (B, S) bit offset of each segment, and the (B,) bit offset of EOB."""
    B = tok["sym"].shape[0]
    is_match, is_lit = tok["is_match"], tok["is_lit"]
    code_l = tables["lit_code"].gather(1, tok["sym"])
    len_l = tables["lit_len"].gather(1, tok["sym"])
    f0_val = torch.where(is_match, code_l | (tok["lextra"] << len_l), code_l)
    f0_bits = torch.where(is_match, len_l + tok["e_l"], torch.where(is_lit, len_l, 0))
    code_d = tables["dist_code"].gather(1, tok["dsym"])
    len_d = tables["dist_len"].gather(1, tok["dsym"])
    f1_val = code_d | (tok["dextra"] << len_d)
    f1_bits = torch.where(is_match, len_d + tok["e_d"], 0)

    per_pos = f0_bits + f1_bits
    base = torch.cumsum(per_pos, -1)
    off_f0 = tables["header_total"][:, None] + base - per_pos
    off_f1 = off_f0 + f0_bits
    off_eob = tables["header_total"] + base[:, -1]

    S = N // SEG
    W = 256
    seg_bit0 = off_f0.reshape(B, S, SEG)[:, :, 0]
    fine = (seg_bit0 >> 3) & (W - 1)
    floc = torch.cat([off_f0.reshape(B, S, SEG), off_f1.reshape(B, S, SEG)], -1) \
        - seg_bit0[:, :, None]
    fvals = torch.cat([f0_val.reshape(B, S, SEG), f1_val.reshape(B, S, SEG)], -1)
    fbits = torch.cat([f0_bits.reshape(B, S, SEG), f1_bits.reshape(B, S, SEG)], -1)
    shifted = torch.where(fbits > 0, (fvals << (floc & 7)) & u32.MASK32, 0)
    bytep = torch.clamp((floc >> 3) + fine[:, :, None], 0, W2 - 1)
    return (bytep.reshape(B * S, 2 * SEG).to(torch.int32),
            u32.to_i32_bits(shifted).reshape(B * S, 2 * SEG), seg_bit0, off_eob)


def _emit(datas, ns, tok, tables, *, cap: int, with_index: bool):
    """Pack tokens into each block's bytes, with the stored-block override.
    Returns ((B, cap) uint8, (B,) length[, (B, S) int64 seg_bits])."""
    B, N = datas.shape
    dev = datas.device
    S = N // SEG
    W = 256
    L = cap + W_SLACK
    bytep, shifted, seg_bit0, off_eob = _pack_inputs(tok, tables, N)
    total_bytes = (off_eob + tables["lit_len"][:, 256] + 3 + 7) // 8  # +3: empty stored header
    row = emit_pack(bytep, shifted).reshape(B, S, W2).to(torch.int64)

    # Shift each row to its segment's bit phase.
    rphase = (seg_bit0 & 7)[:, :, None]
    prev = F.pad(row[:, :, :-1], (1, 0))
    row_sh = ((row << rphase) | (prev >> (8 - rphase))) & 0xFF

    # Coarse placement: row byte j of a segment lands at its 256-byte slot
    # start + j. Overlaps are bit-disjoint, so adding composes them.
    qrow = seg_bit0 >> 11  # (global byte) >> 8
    dst = qrow[:, :, None] * W + torch.arange(W2, device=dev)
    dst = torch.where(dst < L, dst, L).reshape(B, -1)
    out = torch.zeros(B, L + 1, dtype=torch.int64, device=dev)
    out.scatter_add_(1, dst, row_sh.reshape(B, -1))

    # Header fields and EOB (bit-disjoint with the tokens).
    hdr_vals, hdr_bits = tables["hdr_vals"], tables["hdr_bits"]
    hoff = torch.cumsum(hdr_bits, -1) - hdr_bits
    hshift = torch.where(hdr_bits > 0, (hdr_vals << (hoff & 7)) & u32.MASK32, 0)
    hbyte = hoff >> 3
    eob_v = tables["lit_code"][:, 256:257] << (off_eob[:, None] & 7)
    eob_byte = (off_eob >> 3)[:, None]
    add_idx = torch.cat([hbyte, hbyte + 1, hbyte + 2,
                         eob_byte, eob_byte + 1, eob_byte + 2], -1)
    add_val = torch.cat([hshift & 0xFF, (hshift >> 8) & 0xFF, (hshift >> 16) & 0xFF,
                         eob_v & 0xFF, (eob_v >> 8) & 0xFF, (eob_v >> 16) & 0xFF], -1)
    out.scatter_add_(1, torch.clamp(add_idx, 0, L - 1), add_val)

    def put(buf, at, table):
        """buf[b, at[b] + i] = table[i]; positions past L are dropped."""
        values = on_device(table, dev)
        idx = at[:, None] + torch.arange(len(values), device=dev)
        idx = torch.where(idx < L, idx, L)
        return buf.scatter_(1, idx, values.expand(B, -1))

    # Sync flush: empty stored block (LEN=0, NLEN=FFFF), byte-aligned.
    put(out, total_bytes, "sync_flush")
    huff_len = total_bytes + 4

    use_stored = tables["use_stored"]
    stored_buf, stored_n = _stored_block(datas, ns, L)
    stored_buf = F.pad(stored_buf, (0, 1))
    # After a stored block the flush's 3 header bits get their own byte.
    put(stored_buf, stored_n, "stored_sync_flush")
    us = use_stored[:, None]
    out = torch.where(us, stored_buf, out)
    out_len = torch.where(use_stored, stored_n + 5, huff_len)
    out_u8 = (out[:, :cap] & 0xFF).to(torch.uint8)
    if with_index:
        # Segment bit offsets, the previous segment's merged-match overflow
        # in bits 24..31; -1 flags a stored block.
        seg_bits = torch.where(us, -1, seg_bit0 | (tok["ov"] << 24))
        return out_u8, out_len, seg_bits
    return out_u8, out_len


def encode_blocks_dyn(blocks: torch.Tensor, lens: torch.Tensor, *,
                      depth: int = 8, with_index: bool = False,
                      check: str = "adler", wcap: int = 32, stride: int = 1,
                      lex_keys: int = 2, matcher: str = "lex",
                      prefer_far: bool = False, run_ext: bool = True):
    """Encode a (B, N) uint8 block matrix with (B,) lengths, matching with
    the lex or the hash matcher (``deflate_v2.match_and_parse_batch``, with
    its ``prefer_far`` and ``run_ext`` variants).

    Returns ``(outs (B, cap) uint8, metas (B, 2) int32)`` and, with
    ``with_index``, ``seg_bits (B, N/128) int32``, where
    ``cap = N + N // 4 + 64`` (the fixed-tree worst case plus headers).
    ``metas[:, 0]`` is the byte count of each block's raw-deflate run
    (ending in a sync flush), ``metas[:, 1]`` the checksum as an int32 bit
    pattern."""
    B, N = blocks.shape
    cap = N + N // 4 + 64
    ns = lens.to(torch.int64)
    is_tok, best_len, best_dist = match_and_parse_batch(
        blocks, ns, depth=depth, wcap=wcap, stride=stride, lex_keys=lex_keys,
        matcher=matcher, prefer_far=prefer_far, run_ext=run_ext)
    tok, lf, df, xl, xd = _tok_hist_from_match(blocks, ns, is_tok, best_len, best_dist)
    chks = _block_checksum(blocks, ns, check)
    tables = _build_tables(lf, df, xl, xd, ns)
    res = _emit(blocks, ns, tok, tables, cap=cap, with_index=with_index)
    metas = u32.to_i32_bits(torch.stack([res[1], chks], 1))
    if with_index:
        return res[0], metas, u32.to_i32_bits(res[2])
    return res[0], metas


def encode_block_dyn(data: torch.Tensor, n, **kw):
    """Single-block form of :func:`encode_blocks_dyn`: (N,) uint8 and a
    length -> ``(out (cap,) uint8, meta (2,) int32[, seg_bits])``."""
    lens = torch.as_tensor(n, dtype=torch.int64, device=data.device).reshape(1)
    return tuple(r[0] for r in encode_blocks_dyn(data[None], lens, **kw))
