"""Shared device LZ stage: lexicographic or hash-bucket matching, run
extension, exact greedy cover and the merge across segment boundaries.

Port of ``compu_tpu/kernels/deflate_jax_v2.py`` (``_u32_words``,
``_sort_stage``, ``_post_match``, ``_merge_seg_boundaries``,
``cover_overflow``, ``match_and_parse``, ``match_and_parse_batch``, the
exports for the zstd/brotli hybrids, ``device_tokens`` and
``device_match_tokens``, and the fixed-Huffman block encode
``encode_block_fixed_v2`` with its closed-form ``_fixed_fields``). Every
function takes a leading block dimension where the reference was vmapped;
the candidate and cover stages run once over the flattened batch, through
the device dispatch of ``lcp_match``, ``match_candidates`` and
``parse_cover``. Integers are int64 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats.deflate import consts

from . import u32
from .checksum import _block_checksum
from .emit_pack import emit_pack
from .lcp_match import lcp_candidates, sort_stage_lex
from .match_candidates import match_candidates
from .parse_cover import parse_cover

SEG = 128          # cover segment; the indexed decoder's segment
WCAP = 32          # default bytes measured per candidate
MAX_LEN = consts.MAX_MATCH
HASH_MUL = 2654435761  # the 3-byte hash's multiplier, as _sort_stage's


def _u32_words(data: torch.Tensor, k: int) -> torch.Tensor:
    """w[..., i] = little-endian 4 bytes at i+4k, wrapping at the block end
    as ``jnp.roll`` does: (B, N) uint8 -> (B, N) int64."""
    u = data.to(torch.int64)
    return (torch.roll(u, -(4 * k), -1)
            | (torch.roll(u, -(4 * k + 1), -1) << 8)
            | (torch.roll(u, -(4 * k + 2), -1) << 16)
            | (torch.roll(u, -(4 * k + 3), -1) << 24))


def _sort_stage(datas: torch.Tensor, ns: torch.Tensor, *, wcap: int) -> list[torch.Tensor]:
    """Per-block stable sort by the 3-byte multiplicative hash.

    ``datas`` (B, N) uint8, ``ns`` (B,) -> ``[hs, ps, w0, ..., w_{wcap/4-1}]``,
    each (B, N) int64 in sort order: the hash, the position and the
    little-endian window words. Positions from n-2 on get the unique key
    ``0x10000 + pos``, so they never match."""
    B, N = datas.shape
    pos = torch.arange(N, device=datas.device, dtype=torch.int64).expand(B, N)
    d0 = datas.to(torch.int64)
    v3 = d0 | (torch.roll(d0, -1, -1) << 8) | (torch.roll(d0, -2, -1) << 16)
    h = ((v3 * HASH_MUL) & u32.MASK32) >> 16
    h = torch.where(pos < ns.to(torch.int64)[:, None] - 2, h, 0x10000 + pos)
    words = [_u32_words(datas, k) for k in range(wcap // 4)]
    _, order = torch.sort(h, dim=-1, stable=True)
    return [x.gather(-1, order) for x in [h, pos, *words]]


def _post_match(datas, ns, ps, best_len_s, best_dist_s, *, wcap: int,
                stride: int = 1, run_ext: bool = True):
    """Sort-back, chain and run extension, and the greedy heuristics.
    Inputs (B, N/stride) in sort order; returns (step, best_len, best_dist,
    in_range, uncl_len), each (B, N) in position order. ``run_ext=False``
    skips the distance-1 run extension (the reference's
    ``COMPU_RUN_EXT=0``)."""
    B, N = datas.shape
    pos = torch.arange(N, device=datas.device, dtype=torch.int64)
    n = ns[:, None]
    in_range = pos < n

    # Sort back to position order: lax.sort((ps, packed)) puts the lane with
    # position p at p // stride. len <= wcap <= 32 fits 6 bits.
    if wcap > 32:
        raise ValueError(f"wcap must be <= 32 for the len|dist<<6 pack, got {wcap}")
    packed = best_len_s | (best_dist_s << 6)
    back = torch.empty_like(packed).scatter_(1, ps // stride, packed)
    best_len = back & 63
    best_dist = back >> 6
    if stride == 2:
        z = torch.zeros_like(best_len)
        best_len = torch.stack([best_len, z], -1).reshape(B, N)
        best_dist = torch.stack([best_dist, z], -1).reshape(B, N)

    # Chain extension: a full-window match continues through the match k
    # positions on when the distances agree (log doubling).
    max_len, seg = MAX_LEN, SEG
    k = wcap
    while k < max_len:
        ahead_len = torch.roll(best_len, -k, -1)
        cond = ((best_len == k) & (torch.roll(best_dist, -k, -1) == best_dist)
                & (ahead_len > 0) & (pos + k < N))
        best_len = torch.where(
            cond, torch.clamp(k + ahead_len, max=max_len), best_len)
        k *= 2

    # Run extension: distance-1 matches by log doubling.
    if run_ext:
        e = (datas == torch.roll(datas, -1, -1)) & (pos < n - 1)
        run = e.to(torch.int64)
        step = 1
        while step < max_len:
            run = run + torch.where(run == step, torch.roll(run, -step, -1), 0)
            step *= 2
        run = torch.clamp(run, max=max_len)
        run_len = torch.roll(run, 1, -1)
        run_len[:, 0] = 0
        use_run = run_len > best_len
        best_len = torch.where(use_run, run_len, best_len)
        best_dist = torch.where(use_run, 1, best_dist)

    # Heuristics.
    limit = torch.clamp(n - pos, max=max_len)
    best_len = torch.minimum(best_len, limit)
    uncl_len = best_len  # pre-segment-clip length, for the boundary merge
    seg_rem = seg - (pos & (seg - 1))
    best_len = torch.minimum(best_len, seg_rem)
    best_len = torch.where(in_range, best_len, 0)
    drop = (best_len == consts.MIN_MATCH) & (best_dist > 4096)
    best_len = torch.where(drop, 0, best_len)
    nxt_len = F.pad(best_len[:, 1:], (0, 1))
    best_len = torch.where(nxt_len > best_len, 0, best_len)  # lazy demote
    take = best_len >= consts.MIN_MATCH
    step_arr = torch.where(take, best_len, 1)
    return step_arr, best_len, best_dist, in_range, uncl_len


def _merge_seg_boundaries(is_tok, best_len, best_dist, ns, uncl_len):
    """Stitch a match that ends exactly on a segment boundary to the next
    segment's first token when the distances agree (or the pre-clip length
    covers that token) and the sum fits 258. Chains of linked boundaries
    merge at odd run positions only, so pairs are disjoint. Returns the
    updated (is_tok, best_len), each (B, N)."""
    B, N = is_tok.shape
    max_len, seg = MAX_LEN, SEG
    S = N // seg
    dev = is_tok.device
    pos = torch.arange(N, device=dev, dtype=torch.int64)
    seg_rem = (seg - (pos & (seg - 1))).reshape(S, seg)
    tl = torch.where(is_tok, best_len, 0).reshape(B, S, seg)
    td = torch.where(is_tok, best_dist, 0).reshape(B, S, seg)
    ends = (tl >= consts.MIN_MATCH) & (tl == seg_rem)
    len_end = torch.where(ends, tl, 0).sum(-1)
    dist_end = torch.where(ends, td, 0).sum(-1)
    has_end = ends.any(-1)
    first_tok = is_tok.reshape(B, S, seg)[:, :, 0]
    first_len = tl[:, :, 0]
    first_dist = td[:, :, 0]
    first_match = first_tok & (first_len >= consts.MIN_MATCH)
    first_cover = torch.where(first_match, first_len,
                              first_tok.to(torch.int64))
    same_dist = (first_match[:, 1:] & (dist_end[:, :-1] == first_dist[:, 1:])
                 & (len_end[:, :-1] + first_len[:, 1:] <= max_len))
    un = torch.where(is_tok, uncl_len, 0).reshape(B, S, seg)
    uncl_end = torch.where(ends, un, 0).sum(-1)
    absorb = (first_tok[:, 1:] & (first_cover[:, 1:] > 0)
              & (uncl_end[:, :-1] >= len_end[:, :-1] + first_cover[:, 1:])
              & (len_end[:, :-1] + first_cover[:, 1:] <= max_len))
    starts = torch.arange(1, S, device=dev, dtype=torch.int64) * seg
    linked = F.pad(has_end[:, :-1] & (same_dist | absorb)
                   & (starts < ns[:, None]), (1, 0))
    # Run position within each chain of linked boundaries (log doubling).
    run = linked.to(torch.int64)
    step = 1
    while step < S:
        prev = F.pad(run[:, :-step], (step, 0))
        run = run + torch.where(run == step, prev, 0)
        step *= 2
    merge = linked & ((run & 1) == 1)
    add = F.pad(torch.where(merge[:, 1:], first_cover[:, 1:], 0), (0, 1))
    new_tl = torch.where(ends & (add[:, :, None] > 0), tl + add[:, :, None], tl)
    best_len = torch.where(is_tok, new_tl.reshape(B, N), best_len)
    drop_first = torch.zeros(B, S, seg, dtype=torch.bool, device=dev)
    drop_first[:, :, 0] = merge
    is_tok = is_tok & ~drop_first.reshape(B, N)
    return is_tok, best_len


def cover_overflow(is_tok, best_len):
    """Per-segment output-coverage overflow (B, N/SEG) int64 in 0..255: how
    far the last token starting before segment s runs into it."""
    B, N = is_tok.shape
    pos = torch.arange(N, device=is_tok.device, dtype=torch.int64)
    end = torch.where(is_tok, pos + torch.clamp(best_len, min=1), 0)
    reach = torch.cummax(end, dim=-1).values
    S = N // SEG
    prev_reach = reach.reshape(B, S, SEG)[:, :, SEG - 1]
    starts = torch.arange(1, S, device=is_tok.device, dtype=torch.int64) * SEG
    ov = F.pad(prev_reach[:, :-1] - starts, (1, 0))
    return torch.clamp(ov, 0, 255)


def match_and_parse_batch(datas: torch.Tensor, ns: torch.Tensor, *,
                          depth: int = 8, max_dist: int = consts.WINDOW_SIZE,
                          wcap: int = WCAP, stride: int = 1,
                          lex_keys: int = 2, matcher: str = "lex",
                          prefer_far: bool = False, run_ext: bool = True):
    """The LZ stage over a (B, N) uint8 block matrix with (B,) lengths.
    Returns (is_tok bool, best_len int64, best_dist int64), each (B, N).
    Matches reach at most ``max_dist`` back (DEFLATE's window by default).

    ``matcher="lex"`` sorts windows lexicographically (``lcp_match``);
    ``"hash"`` sorts by the 3-byte hash (``match_candidates``), and then,
    as the reference, always takes stride 1 and ignores ``lex_keys``.
    The reference's two matcher switches are parameters here:
    ``prefer_far`` (``COMPU_LCP_TIE=far``: the lex matcher's equal lengths
    take the farther source) and ``run_ext=False`` (``COMPU_RUN_EXT=0``:
    no distance-1 run extension)."""
    B, N = datas.shape
    ns = ns.to(torch.int64)
    if matcher == "lex":
        *wbe, ps = sort_stage_lex(datas, wcap=wcap, keys=lex_keys, stride=stride)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
        bl_f, bd_f = lcp_candidates(
            words, ps.reshape(-1).to(torch.int32), depth=depth,
            max_dist=max_dist, block_elems=N // stride, prefer_far=prefer_far)
    elif matcher == "hash":
        stride = 1
        hs, ps, *sw = _sort_stage(datas, ns, wcap=wcap)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in sw]))
        bl_f, bd_f = match_candidates(
            hs.reshape(-1).to(torch.int32), ps.reshape(-1).to(torch.int32), words,
            depth=depth, max_dist=max_dist, block_elems=N)
    else:
        raise ValueError(f"matcher must be 'lex' or 'hash', got {matcher!r}")
    best_len_s = bl_f.reshape(B, N // stride).to(torch.int64)
    best_dist_s = bd_f.reshape(B, N // stride).to(torch.int64)
    step_arr, best_len, best_dist, in_range, uncl = _post_match(
        datas, ns, ps, best_len_s, best_dist_s, wcap=wcap, stride=stride, run_ext=run_ext)
    is_tok = parse_cover(step_arr.reshape(-1)).reshape(B, N) & in_range
    is_tok, best_len = _merge_seg_boundaries(is_tok, best_len, best_dist, ns, uncl)
    return is_tok, best_len, best_dist


def match_and_parse(data: torch.Tensor, n, **kw):
    """Single-block form of :func:`match_and_parse_batch`: (N,) uint8 and a
    length -> (is_tok, best_len, best_dist), each (N,)."""
    ns = torch.as_tensor(n, dtype=torch.int64, device=data.device).reshape(1)
    return tuple(r[0] for r in match_and_parse_batch(data[None], ns, **kw))


def device_tokens(data: torch.Tensor, n, *, depth: int = 8,
                  max_dist: int = consts.WINDOW_SIZE) -> torch.Tensor:
    """The shared LZ stage's cover as one packed (N,) int32: bit 0 is_tok,
    bits 1-9 the match length (0 for a literal), bits 10-30 the distance
    (21 bits, so ``max_dist < 2^21``). Port of ``device_tokens``."""
    if not max_dist < (1 << 21):
        raise ValueError(f"max_dist {max_dist} overflows the 21-bit field")
    is_tok, best_len, best_dist = match_and_parse(data, n, depth=depth, max_dist=max_dist)
    take = best_len >= consts.MIN_MATCH
    mlen = torch.where(take, best_len, 0)
    packed = 1 | (mlen << 1) | (torch.where(take, best_dist, 0) << 10)
    return torch.where(is_tok, packed, 0).to(torch.int32)


def device_match_tokens(data: torch.Tensor, n, *, depth: int = 8,
                        max_dist: int = consts.WINDOW_SIZE, cap: int = 0):
    """Matches only: ``(packed, count)`` with ``packed`` a (cap, 2) int32 of
    ``pos | len << 20`` and ``dist`` per match in position order, rows from
    ``count`` on set to -1, and ``count`` the number of matches (a 0-dim
    tensor). ``count > cap`` means the matches did not fit: the caller
    takes :func:`device_tokens` instead. ``cap`` defaults to N // 6 + 64.
    Port of ``device_match_tokens``; ``jnp.nonzero(size=cap,
    fill_value=N)`` is ``torch.nonzero`` padded with N or cut to cap."""
    if not max_dist < (1 << 21):
        raise ValueError(f"max_dist {max_dist} overflows the 21-bit field")
    N = data.shape[0]
    if N > (1 << 20):
        raise ValueError(f"the pos field is 20 bits: N = {N} > 2^20")
    cap = cap or (N // 6 + 64)
    is_tok, best_len, best_dist = match_and_parse(data, n, depth=depth, max_dist=max_dist)
    is_match = is_tok & (best_len >= consts.MIN_MATCH)
    count = is_match.sum(dtype=torch.int32)
    idx = torch.nonzero(is_match).reshape(-1)[:cap]
    idx = F.pad(idx, (0, cap - idx.shape[0]), value=N)
    live = torch.arange(cap, device=data.device) < count
    pos = torch.where(live, idx, 0)
    at = torch.clamp(idx, 0, N - 1)
    a = torch.where(live, pos | (best_len[at] << 20), -1)
    b = torch.where(live, best_dist[at], -1)
    return torch.stack([a, b], 1).to(torch.int32), count


# ---------------------------------------------------------------------------
# The v2 block encode: fixed Huffman codes only
# ---------------------------------------------------------------------------

def _rev9(x: torch.Tensor) -> torch.Tensor:
    """Reverse the low 9 bits."""
    r = torch.zeros_like(x)
    for i in range(9):
        r = r | (((x >> i) & 1) << (8 - i))
    return r


def _rev(x: torch.Tensor, bits) -> torch.Tensor:
    """Reverse ``x`` within ``bits`` (<= 9) bits."""
    return _rev9(x) >> (9 - bits)


def _fixed_fields(data, mlen, dclip, is_match_tok, is_lit):
    """Fixed-Huffman token fields in closed form (RFC 1951 §3.2.5-3.2.6):
    ``(f0_val, f0_bits, f1_val, f1_bits)``, int64 of ``data``'s shape. f0 is
    a literal's code, or a match's length code with its extra bits; f1 the
    match's distance code with its extra bits."""
    m = mlen - consts.MIN_MATCH
    e_l = ((m >= 8).to(torch.int64) + (m >= 16) + (m >= 32) + (m >= 64) + (m >= 128))
    lsym = 257 + (e_l << 2) + (m >> e_l)
    lextra = m & ((1 << e_l) - 1)
    is258 = mlen == consts.MAX_MATCH  # length 258 has its own zero-extra symbol 285
    lsym = torch.where(is258, 285, lsym)
    e_l = torch.where(is258, 0, e_l)
    lextra = torch.where(is258, 0, lextra)
    # symbols 256-279: 7-bit codes sym - 256; 280-287: 8-bit codes 0xC0 + sym - 280
    lcode_bits = torch.where(lsym >= 280, 8, 7)
    lcode = torch.where(lsym >= 280, 0xC0 + (lsym - 280), lsym - 256)
    lrev = _rev(lcode, lcode_bits)

    ds = dclip - 1
    e_d = (ds >= 4).to(torch.int64)
    for k in range(3, 15):
        e_d = e_d + (ds >= (1 << k))
    dsym = torch.where(ds < 2, ds, 2 * (e_d + 1) + ((ds >> e_d) & 1))
    dextra = ds & ((1 << e_d) - 1)
    drev = _rev(dsym, 5)  # every fixed distance code is 5 bits

    v = data.to(torch.int64)
    lit_bits = torch.where(v >= 144, 9, 8)
    lit_rev = _rev(torch.where(v >= 144, 0x190 + (v - 144), 0x30 + v), lit_bits)

    f0_val = torch.where(is_match_tok, lrev | (lextra << lcode_bits), lit_rev)
    f0_bits = torch.where(is_match_tok, lcode_bits + e_l, torch.where(is_lit, lit_bits, 0))
    f1_val = drev | (dextra << 5)
    f1_bits = torch.where(is_match_tok, 5 + e_d, 0)
    return f0_val, f0_bits, f1_val, f1_bits


FIXED_ROW = 256  # bytes of a segment's row (its fields reach at most ~150)


def _fixed_pack_inputs(datas, is_tok, best_len, best_dist):
    """The fixed-Huffman fields of every token, cut into segment rows.

    Returns ``(bytep, shifted, seg_bit0, total_bytes)``: (B*S, 256) int32
    row byte positions and u32 bit patterns of the f0 and f1 fields of each
    128-byte segment, the input of ``emit_pack``; the (B, S) bit offset of
    each segment's first field; and the (B,) byte count of the block up to
    its sync flush's tail."""
    B, N = datas.shape
    take = best_len >= consts.MIN_MATCH
    f0_val, f0_bits, f1_val, f1_bits = _fixed_fields(
        datas, torch.clamp(best_len, consts.MIN_MATCH, consts.MAX_MATCH),
        torch.clamp(best_dist, 1, consts.WINDOW_SIZE), is_tok & take, is_tok & ~take)
    per_pos = f0_bits + f1_bits
    base = torch.cumsum(per_pos, -1)
    off_f0 = 3 + base - per_pos  # after the 3-bit block header
    off_f1 = off_f0 + f0_bits
    # EOB's fixed code is seven 0 bits, then the sync flush's 3 header bits.
    total_bytes = (3 + base[:, -1] + 7 + 3 + 7) // 8

    S = N // SEG
    seg_bit0 = off_f0.reshape(B, S, SEG)[:, :, 0]
    floc = (torch.cat([off_f0.reshape(B, S, SEG), off_f1.reshape(B, S, SEG)], -1)
            - seg_bit0[:, :, None])
    fvals = torch.cat([f0_val.reshape(B, S, SEG), f1_val.reshape(B, S, SEG)], -1)
    fbits = torch.cat([f0_bits.reshape(B, S, SEG), f1_bits.reshape(B, S, SEG)], -1)
    shifted = torch.where(fbits > 0, (fvals << (floc & 7)) & u32.MASK32, 0)
    bytep = floc >> 3
    if datas.device.type == "cpu" and int(bytep.max()) >= FIXED_ROW - 4:
        # A segment's fields span at most ~150 bytes (9 bits a literal, 31 a
        # match of 3 or more), so each lies in the first FIXED_ROW bytes of
        # its row, as the reference's rows need. Checked where it costs no
        # device sync.
        raise AssertionError(f"a field starts at row byte {int(bytep.max())}")
    return (bytep.reshape(B * S, 2 * SEG).to(torch.int32),
            u32.to_i32_bits(shifted).reshape(B * S, 2 * SEG), seg_bit0, total_bytes)


def _place_rows(row: torch.Tensor, seg_bit0: torch.Tensor, total_bytes: torch.Tensor,
                cap: int) -> torch.Tensor:
    """The block bytes (B, cap) uint8 from the packed (B*S, 512) segment
    rows: each row shifted to its segment's bit phase, its bytes after the
    first placed by one masked scatter as the reference's ascending row
    writes leave them (a later row wins where two overlap), the rows' first
    bytes and the block header (bfinal 0, btype 01) added on top, and the
    sync flush's ``00 00 FF FF`` written at ``total_bytes``."""
    B, S = seg_bit0.shape
    dev = row.device
    W = FIXED_ROW
    row = row[:, :W].reshape(B, S, W).to(torch.int64)
    r = (seg_bit0 & 7)[:, :, None]
    prev = F.pad(row[:, :, :-1], (1, 0))
    row_sh = ((row << r) | (prev >> (8 - r))) & 0xFF
    gbyte = seg_bit0 >> 3
    # Row s's bytes 1..W-1 land at start[s]..start[s]+W-2 (the reference's
    # update slice, its start clamped into the buffer), and only below the
    # next row's start.
    L = cap + W
    start = torch.clamp(gbyte + 1, max=L - (W - 1))
    dst = start[:, :, None] + torch.arange(W - 1, device=dev)
    nxt = torch.cat([start[:, 1:], torch.full((B, 1), L, device=dev, dtype=torch.int64)], -1)
    dst = torch.where(dst < nxt[:, :, None], dst, L)
    out = torch.zeros(B, L + 1, dtype=torch.int64, device=dev)
    out.scatter_(1, dst.reshape(B, -1), row_sh[:, :, 1:].reshape(B, -1))
    add_idx = torch.cat([gbyte, torch.zeros(B, 1, dtype=torch.int64, device=dev)], -1)
    add_val = torch.cat([row_sh[:, :, 0], torch.full((B, 1), 2, device=dev)], -1)
    out.scatter_add_(1, torch.clamp(add_idx, 0, L - 1), add_val)
    tail = torch.tensor([0, 0, 0xFF, 0xFF], device=dev, dtype=torch.int64)
    out.scatter_(1, total_bytes[:, None] + torch.arange(4, device=dev), tail.expand(B, 4))
    return (out[:, :cap] & 0xFF).to(torch.uint8)


def encode_blocks_fixed_v2(blocks: torch.Tensor, lens: torch.Tensor, *, depth: int = 8,
                           cap: int = 0, with_index: bool = False, check: str = "adler",
                           prefer_far: bool = False, run_ext: bool = True):
    """The v2 block encode of a (B, N) uint8 block matrix with (B,) lengths:
    one fixed-Huffman block each, matched by :func:`match_and_parse_batch`
    at its defaults (the lex matcher, wcap 32, two sort keys, stride 1,
    ``depth`` as given), ending in a sync flush.

    Returns ``(outs (B, cap) uint8, metas (B, 2) int32)`` and, with
    ``with_index``, ``seg_bits (B, N/128) int32``: each segment's first
    token's bit offset, the previous segment's merged-match overflow in
    bits 24-31. ``metas`` is ``[len, check]``, ``check`` the adler32 of the
    block (``"adler"``) or the raw init-0 CRC register of the padded block
    (``"crc"``). ``cap`` defaults to N + N // 4 + 64.

    The pack is the reference's: each 128-byte segment's 256 fields go
    into a segment row by ``emit_pack`` (kernel B3 on CUDA), and
    :func:`_place_rows` places the rows."""
    B, N = blocks.shape
    ns = lens.to(torch.int64)
    is_tok, best_len, best_dist = match_and_parse_batch(
        blocks, ns, depth=depth, prefer_far=prefer_far, run_ext=run_ext)
    bytep, shifted, seg_bit0, total_bytes = _fixed_pack_inputs(blocks, is_tok, best_len,
                                                               best_dist)
    outs = _place_rows(emit_pack(bytep, shifted), seg_bit0, total_bytes,
                       cap or N + N // 4 + 64)
    metas = u32.to_i32_bits(torch.stack([total_bytes + 4, _block_checksum(blocks, ns, check)], 1))
    if with_index:
        return outs, metas, u32.to_i32_bits(seg_bit0 | (cover_overflow(is_tok, best_len) << 24))
    return outs, metas


def encode_block_fixed_v2(data: torch.Tensor, n, **kw):
    """Single-block form of :func:`encode_blocks_fixed_v2`: (N,) uint8 and a
    length -> ``(out (cap,) uint8, meta (2,) int32[, seg_bits])``."""
    lens = torch.as_tensor(n, dtype=torch.int64, device=data.device).reshape(1)
    return tuple(r[0] for r in encode_blocks_fixed_v2(data[None], lens, **kw))
