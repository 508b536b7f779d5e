"""Shared device LZ stage: lexicographic or hash-bucket matching, run
extension, exact greedy cover and the merge across segment boundaries.

Port of ``compu_tpu/kernels/deflate_jax_v2.py`` (``_u32_words``,
``_sort_stage``, ``_post_match``, ``_merge_seg_boundaries``,
``cover_overflow``, ``match_and_parse``, ``match_and_parse_batch``). Every
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
                stride: int = 1):
    """Sort-back, chain and run extension, and the greedy heuristics.
    Inputs (B, N/stride) in sort order; returns (step, best_len, best_dist,
    in_range, uncl_len), each (B, N) in position order."""
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
                          depth: int = 8, wcap: int = WCAP, stride: int = 1,
                          lex_keys: int = 2, matcher: str = "lex"):
    """The LZ stage over a (B, N) uint8 block matrix with (B,) lengths.
    Returns (is_tok bool, best_len int64, best_dist int64), each (B, N).

    ``matcher="lex"`` sorts windows lexicographically (``lcp_match``);
    ``"hash"`` sorts by the 3-byte hash (``match_candidates``), and then,
    as the reference, always takes stride 1 and ignores ``lex_keys``."""
    B, N = datas.shape
    ns = ns.to(torch.int64)
    if matcher == "lex":
        *wbe, ps = sort_stage_lex(datas, wcap=wcap, keys=lex_keys, stride=stride)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
        bl_f, bd_f = lcp_candidates(
            words, ps.reshape(-1).to(torch.int32), depth=depth,
            max_dist=consts.WINDOW_SIZE, block_elems=N // stride)
    elif matcher == "hash":
        stride = 1
        hs, ps, *sw = _sort_stage(datas, ns, wcap=wcap)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in sw]))
        bl_f, bd_f = match_candidates(
            hs.reshape(-1).to(torch.int32), ps.reshape(-1).to(torch.int32), words,
            depth=depth, max_dist=consts.WINDOW_SIZE, block_elems=N)
    else:
        raise ValueError(f"matcher must be 'lex' or 'hash', got {matcher!r}")
    best_len_s = bl_f.reshape(B, N // stride).to(torch.int64)
    best_dist_s = bd_f.reshape(B, N // stride).to(torch.int64)
    step_arr, best_len, best_dist, in_range, uncl = _post_match(
        datas, ns, ps, best_len_s, best_dist_s, wcap=wcap, stride=stride)
    is_tok = parse_cover(step_arr.reshape(-1)).reshape(B, N) & in_range
    is_tok, best_len = _merge_seg_boundaries(is_tok, best_len, best_dist, ns, uncl)
    return is_tok, best_len, best_dist


def match_and_parse(data: torch.Tensor, n, **kw):
    """Single-block form of :func:`match_and_parse_batch`: (N,) uint8 and a
    length -> (is_tok, best_len, best_dist), each (N,)."""
    ns = torch.as_tensor(n, dtype=torch.int64, device=data.device).reshape(1)
    return tuple(r[0] for r in match_and_parse_batch(data[None], ns, **kw))
