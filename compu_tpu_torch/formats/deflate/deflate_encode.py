"""The host DEFLATE encoder core (the port's copy of
``compu_tpu/formats/deflate/deflate_encode.py``).

1. *Match finding*: hash every position's 3-byte prefix, link equal-hash
   positions into chains, walk each chain ``depth`` steps and measure the
   candidates' match lengths (``find_matches``, and ``find_matches_k`` for
   up to K pareto candidates a position).
2. *Parse*: the greedy/lazy cover as a path 0 -> nxt[0] -> ... with
   ``nxt[i] = i + len(i)`` (``greedy_cover``); level 9 runs a two-round
   cost-model DP instead (``_optimal_parse``).
3. *Entropy stage*: histograms, optimal length-limited Huffman codes,
   token-to-field mapping and prefix-sum bit packing, block by block
   (``DeflateStream``), with the stream's partial byte carried across calls.

Above 4096 bytes the chain walks, the cover and every round of the DP run
in the host runtime (``runtime/native.py``); below, in the numpy and
Python twins (``find_matches_py``, ``find_matches_k_py``,
``greedy_cover_py``, ``_squeeze_py``), which give the same arrays and are
what the tests hold the runtime against. Matches never cross the
pipeline's 1 MiB block (the window resets a block), so a stream of this
encoder decodes block by block; within a block they reach 32 KiB back.
"""

from __future__ import annotations

import numpy as np

from ...ops.bitio import pack_bits, reverse_bits
from ...ops.huffman import canonical_codes, length_limited_lengths
from ...runtime import native
from . import consts
from .options import ZlibStrategy

# Chain-walk depth per compression level (level 0 = stored, handled above).
LEVEL_DEPTH = [0, 1, 2, 4, 4, 8, 8, 16, 24, 32]
# Stop extending a position's chain once its match reaches this length
# (zlib's nice_length ladder).
LEVEL_NICE = [0, 8, 16, 32, 32, 64, 128, 128, 258, 258]
# Lazy matching kicks in at level >= 4 (as in zlib).
LEVEL_LAZY = [False, False, False, False, True, True, True, True, True, True]

SUBBLOCK = 65536  # input bytes per deflate block (adaptive Huffman locality)


# ---------------------------------------------------------------------------
# Match finding
# ---------------------------------------------------------------------------
def _build_u64_view(data: np.ndarray, pad: int) -> np.ndarray:
    """u64[i] = little-endian 8 bytes at i (zero-padded past the end)."""
    padded = np.zeros(len(data) + pad, dtype=np.uint8)
    padded[: len(data)] = data
    u64 = np.zeros(len(data) + pad - 8, dtype=np.uint64)
    for k in range(8):
        u64 |= padded[k : k + len(u64)].astype(np.uint64) << np.uint64(8 * k)
    return u64


def _match_lengths(u64: np.ndarray, pos: np.ndarray, cand: np.ndarray, limit: np.ndarray) -> np.ndarray:
    """Common-prefix length of data[pos:] vs data[cand:], capped at limit.

    8-byte XOR steps over a shrinking active set — every pair advances in
    lockstep, so the loop count is bounded by max_len/8.
    """
    m = len(pos)
    lens = np.zeros(m, dtype=np.int64)
    active = np.arange(m)
    while active.size:
        a = u64[pos[active] + lens[active]]
        b = u64[cand[active] + lens[active]]
        x = a ^ b
        # Matching byte count = trailing-zero bytes of the XOR:
        # popcount((x & -x) - 1) >> 3, with x == 0 meaning all 8 match.
        low = x & (np.uint64(0) - x)
        cnt = (np.bitwise_count(low - np.uint64(1)) >> np.uint8(3)).astype(np.int64)
        cnt = np.where(x == 0, np.int64(8), cnt)
        lens[active] += cnt
        keep = (cnt == 8) & (lens[active] < limit[active])
        active = active[keep]
    return np.minimum(lens, limit)


def find_matches(data: np.ndarray, level: int, strategy: ZlibStrategy,
                 max_dist: int = consts.WINDOW_SIZE, depth: int = 0,
                 hash_bits: int = 16, patience: int = 0,
                 hash6_depth: int = 0):
    """Best (length, distance) per position. Returns (lens, dists) int64
    arrays; positions without a usable match have len 0. ``max_dist``
    widens the window for formats whose distances exceed DEFLATE's 32 KiB;
    ``depth`` overrides the level ladder's chain-walk depth; ``hash_bits``
    sizes the 3-byte-prefix hash (mem_level + 8). Above 4096 bytes (and
    with matches that are not run-length only) the host runtime walks the
    chains; below, ``find_matches_py``."""
    if (len(data) > 4096
            and strategy not in (ZlibStrategy.Rle, ZlibStrategy.HuffmanOnly)):
        return native.find_matches(
            data.tobytes(), max_dist, depth or LEVEL_DEPTH[level],
            LEVEL_NICE[level], hash_bits, patience, hash6_depth,
            strategy is ZlibStrategy.Filtered)
    return find_matches_py(data, level, strategy, max_dist, depth, hash_bits,
                           patience, hash6_depth)


def find_matches_py(data: np.ndarray, level: int, strategy: ZlibStrategy,
                    max_dist: int = consts.WINDOW_SIZE, depth: int = 0,
                    hash_bits: int = 16, patience: int = 0,
                    hash6_depth: int = 0):
    """The numpy twin of ``find_matches``: one stable argsort links the
    chains, and all positions walk them together by gathers, their match
    lengths measured 8 bytes at a time over a shrinking active set."""
    n = len(data)
    lens = np.zeros(n, dtype=np.int64)
    dists = np.zeros(n, dtype=np.int64)
    if n < consts.MIN_MATCH + 1 or strategy is ZlibStrategy.HuffmanOnly:
        return lens, dists

    u64 = _build_u64_view(data, consts.MAX_MATCH + 16)
    limit = np.minimum(consts.MAX_MATCH, n - np.arange(n))

    if strategy is ZlibStrategy.Rle:
        # Distance-1 matches only (run-length mode).
        pos = np.arange(1, n)
        cand = pos - 1
        l = _match_lengths(u64, pos, cand, limit[1:])
        ok = l >= consts.MIN_MATCH
        lens[pos[ok]] = l[ok]
        dists[pos[ok]] = 1
        return lens, dists

    m = n - 2  # positions with a full 3-byte prefix
    v = (
        data[:m].astype(np.uint32)
        | (data[1 : m + 1].astype(np.uint32) << np.uint32(8))
        | (data[2 : m + 2].astype(np.uint32) << np.uint32(16))
    )
    h = ((v * np.uint32(2654435761)) >> np.uint32(32 - hash_bits)).astype(np.uint32)
    # prev[i] = nearest earlier position with the same hash (-1 if none):
    # one stable sort groups positions by hash in position order.
    order = np.argsort(h, kind="stable")
    prev = np.full(m, -1, dtype=np.int64)
    same = h[order[1:]] == h[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]

    depth = depth or LEVEL_DEPTH[level]
    nice = LEVEL_NICE[level]
    pos_all = np.arange(m)
    cand = prev
    best_len = np.zeros(m, dtype=np.int64)
    best_dist = np.zeros(m, dtype=np.int64)
    retire = np.minimum(nice, limit[:m])

    if patience or hash6_depth:
        # Deep-quality ladders: seed with a distance-1 pre-pass so run
        # positions retire immediately (their hash-3 chains are the
        # pathological ones — every position of a run shares a bucket).
        p1 = np.arange(1, m)
        l1 = _match_lengths(u64, p1, p1 - 1, limit[1:m])
        take1 = l1 > best_len[1:]
        best_len[1:][take1] = l1[take1]
        best_dist[1:][take1] = 1

    def _hash6_walk():
        # 6-byte-prefix hash chains: a hash-6 bucket holds only positions
        # sharing a 6-byte prefix (minus collisions), so its chain is
        # precisely the long-match candidate list — a depth-d walk here
        # replaces a much deeper hash-3 walk for the far/long matches the
        # deep-quality ladders exist to find (libbrotli's q10/11 role).
        # Runs BEFORE the hash-3 walk so long matches retire positions
        # early and shrink the hash-3 frontier.
        m6 = m - 3  # positions with a full 6-byte prefix (m = n - 2)
        v6 = u64[:m6] & np.uint64(0xFFFFFFFFFFFF)
        h6 = ((v6 * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(47)).astype(np.uint64)
        order6 = np.argsort(h6, kind="stable")
        prev6 = np.full(m6, -1, dtype=np.int64)
        same6 = h6[order6[1:]] == h6[order6[:-1]]
        prev6[order6[1:][same6]] = order6[:-1][same6]
        act = np.nonzero((prev6 >= 0) & (best_len[:m6] < retire[:m6]))[0]
        cand_a = prev6[act]
        for _ in range(hash6_depth):
            keep = (cand_a >= 0) & (act - cand_a <= max_dist) & (
                best_len[act] < retire[act]
            )
            act = act[keep]
            cand_a = cand_a[keep]
            if act.size == 0:
                break
            l = _match_lengths(u64, act, cand_a, limit[act])
            better = l > best_len[act]
            upd = act[better]
            best_len[upd] = l[better]
            best_dist[upd] = upd - cand_a[better]
            cand_a = prev6[cand_a]

    if hash6_depth and m > 8:
        _hash6_walk()

    if patience:
        # Compacted deep walk (q10/q11 ladders): the walk operates on the
        # ACTIVE frontier only, so per-step cost tracks the shrinking set
        # instead of m; positions retire at nice/limit like the flat walk,
        # or after `patience` steps with no improvement (improvements
        # cluster at the chain front on real data, so the frontier decays
        # geometrically while deep late finds are still kept).
        act = np.nonzero((cand >= 0) & (best_len < retire))[0]
        cand_a = cand[act]
        li_a = np.zeros(len(act), dtype=np.int64)
        for step in range(depth):
            keep = (
                (cand_a >= 0)
                & (act - cand_a <= max_dist)
                & (best_len[act] < retire[act])
                & ((step - li_a) < patience)
            )
            act = act[keep]
            cand_a = cand_a[keep]
            li_a = li_a[keep]
            if act.size == 0:
                break
            l = _match_lengths(u64, act, cand_a, limit[act])
            better = l > best_len[act]
            upd = act[better]
            best_len[upd] = l[better]
            best_dist[upd] = upd - cand_a[better]
            li_a[better] = step
            cand_a = prev[cand_a]
    else:
        for _ in range(depth):
            valid = (cand >= 0) & (pos_all - cand <= max_dist)
            idx = np.nonzero(valid & (best_len < retire))[0]
            if idx.size == 0:
                break
            l = _match_lengths(u64, idx, cand[idx], limit[idx])
            better = l > best_len[idx]
            upd = idx[better]
            best_len[upd] = l[better]
            best_dist[upd] = upd - cand[upd]
            # step chains: candidate of the candidate
            cand = np.where(cand >= 0, prev[np.maximum(cand, 0)], -1)

    ok = best_len >= consts.MIN_MATCH
    # zlib "too far" heuristic: a 3-byte match beyond 4096 costs more than
    # the literals it replaces.
    ok &= ~((best_len == consts.MIN_MATCH) & (best_dist > 4096))
    if strategy is ZlibStrategy.Filtered:
        # Favor literals: only take clearly-winning matches.
        ok &= best_len >= 5
    lens[:m][ok] = best_len[ok]
    dists[:m][ok] = best_dist[ok]
    return lens, dists


def find_matches_k(data: np.ndarray, level: int, max_dist: int, K: int = 3,
                   depth: int = 0, deflate_heuristics: bool = True,
                   hash_bits: int = 16):
    """Pareto match candidates per position: up to K (length, distance)
    pairs. The chain walk visits candidates nearest-first, so every strict
    length improvement is pareto-optimal (longer but farther); slots fill
    in discovery order and slot K-1 keeps the longest. Cost-model parses
    use the shorter-but-closer candidates when offset bits beat
    match-length gains. ``depth`` overrides the level ladder;
    ``deflate_heuristics=False`` keeps short far matches (formats with
    repeat offsets price them in their DP instead). Above 4096 bytes the
    host runtime walks the chains; below, ``find_matches_k_py``."""
    if len(data) > 4096:
        return native.find_matches_k(
            data.tobytes(), max_dist, K, depth or LEVEL_DEPTH[min(level, 9)],
            LEVEL_NICE[min(level, 9)], deflate_heuristics, hash_bits)
    return find_matches_k_py(data, level, max_dist, K, depth, deflate_heuristics, hash_bits)


def find_matches_k_py(data: np.ndarray, level: int, max_dist: int, K: int = 3,
                      depth: int = 0, deflate_heuristics: bool = True,
                      hash_bits: int = 16):
    """The numpy twin of ``find_matches_k``."""
    n = len(data)
    lens_k = np.zeros((n, K), dtype=np.int64)
    dists_k = np.zeros((n, K), dtype=np.int64)
    if n < consts.MIN_MATCH + 1:
        return lens_k, dists_k
    u64 = _build_u64_view(data, consts.MAX_MATCH + 16)
    limit = np.minimum(consts.MAX_MATCH, n - np.arange(n))
    m = n - 2
    v = (
        data[:m].astype(np.uint32)
        | (data[1 : m + 1].astype(np.uint32) << np.uint32(8))
        | (data[2 : m + 2].astype(np.uint32) << np.uint32(16))
    )
    h = ((v * np.uint32(2654435761)) >> np.uint32(32 - hash_bits)).astype(np.uint32)
    order = np.argsort(h, kind="stable")
    prev = np.full(m, -1, dtype=np.int64)
    same = h[order[1:]] == h[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]

    depth = depth or LEVEL_DEPTH[min(level, 9)]
    nice = LEVEL_NICE[min(level, 9)]
    pos_all = np.arange(m)
    cand = prev
    best_len = np.zeros(m, dtype=np.int64)
    cnt = np.zeros(m, dtype=np.int64)
    # A position retires once its match hits the smaller of nice and its
    # own end-of-block limit — otherwise tail positions keep every deep
    # walk alive for the full depth on degenerate (run) chains.
    retire = np.minimum(nice, limit[:m])
    for _ in range(depth):
        valid = (cand >= 0) & (pos_all - cand <= max_dist)
        idx = np.nonzero(valid & (best_len < retire))[0]
        if idx.size == 0:
            break
        l = _match_lengths(u64, idx, cand[idx], limit[idx])
        better = l > best_len[idx]
        upd = idx[better]
        best_len[upd] = l[better]
        slot = np.minimum(cnt[upd], K - 1)
        lens_k[upd, slot] = l[better]
        dists_k[upd, slot] = upd - cand[upd]
        cnt[upd] += 1
        cand = np.where(cand >= 0, prev[np.maximum(cand, 0)], -1)
    if deflate_heuristics:
        # zlib "too far" heuristic per slot.
        bad = (lens_k == consts.MIN_MATCH) & (dists_k > 4096)
        lens_k[bad] = 0
        dists_k[bad] = 0
    return lens_k, dists_k


def greedy_cover(nxt: np.ndarray) -> np.ndarray:
    """Token start positions: the path 0 -> nxt[0] -> ... -> n. Above 4096
    positions the host runtime follows it; below, ``greedy_cover_py``."""
    if len(nxt) > 4096:
        return native.greedy_cover(nxt)
    return greedy_cover_py(nxt)


def greedy_cover_py(nxt: np.ndarray) -> np.ndarray:
    """The numpy twin of ``greedy_cover``, by pointer doubling: after k
    rounds the path's first 2^k nodes are marked and the jump table
    advances 2^k steps."""
    n = len(nxt)
    jump = np.concatenate([nxt, [n]]).astype(np.int64)
    on_path = np.zeros(n + 1, dtype=bool)
    on_path[0] = True
    count = 1
    while True:
        targets = jump[on_path.nonzero()[0]]
        on_path[targets] = True
        new_count = int(on_path.sum())
        if new_count == count:
            break
        count = new_count
        jump = jump[jump]
    return on_path[:n].nonzero()[0]


def tokenize(data: np.ndarray, level: int, strategy: ZlibStrategy,
             max_dist: int = consts.WINDOW_SIZE, depth: int = 0,
             hash_bits: int = 16, patience: int = 0, hash6_depth: int = 0):
    """Full parse: returns (token_pos, tok_len, tok_dist) where tok_len==0
    marks a literal token. Level 9 runs the cost-model optimal parse."""
    n = len(data)
    lens, dists = find_matches(data, level, strategy, max_dist, depth=depth,
                               hash_bits=hash_bits, patience=patience,
                               hash6_depth=hash6_depth)
    if level >= 9 and strategy in (ZlibStrategy.Default, ZlibStrategy.Filtered) and n > 16:
        return _optimal_parse(data, lens, dists)
    if LEVEL_LAZY[level] and n > 1:
        # Lazy heuristic: if the next position has a strictly longer match,
        # demote this one to a literal.
        demote = np.zeros(n, dtype=bool)
        demote[:-1] = lens[1:] > lens[:-1]
        lens = np.where(demote, 0, lens)
    take = lens >= consts.MIN_MATCH
    nxt = np.arange(n) + np.where(take, lens, 1)
    tok_pos = greedy_cover(nxt)
    tl = lens[tok_pos] * take[tok_pos]
    td = dists[tok_pos] * take[tok_pos]
    return tok_pos, tl, td


def _greedy_tokens(data, lens, dists):
    n = len(data)
    l2 = lens.copy()
    demote = np.zeros(n, dtype=bool)
    demote[:-1] = l2[1:] > l2[:-1]
    l2 = np.where(demote, 0, l2)
    take = l2 >= consts.MIN_MATCH
    nxt = np.arange(n) + np.where(take, l2, 1)
    tok_pos = greedy_cover(nxt)
    return tok_pos, l2[tok_pos] * take[tok_pos], dists[tok_pos] * take[tok_pos]


def _cost_tables(data, tok_pos, tok_len, tok_dist):
    """Per-symbol bit costs (huffman lengths) estimated from a parse."""
    is_match = tok_len > 0
    lit_syms = np.where(
        is_match, consts.LENGTH_CODE[np.minimum(tok_len, consts.MAX_MATCH)], data[tok_pos]
    ).astype(np.int64)
    lit_freq = np.bincount(lit_syms, minlength=286)
    lit_freq[256] += 1
    md = tok_dist[is_match]
    dsyms = consts.DIST_CODE[np.minimum(md, consts.WINDOW_SIZE)]
    dist_freq = np.bincount(dsyms[md <= consts.WINDOW_SIZE], minlength=30)
    lit_len = length_limited_lengths(lit_freq, 15).astype(np.float64)
    dist_len = length_limited_lengths(np.maximum(dist_freq, 0), 15).astype(np.float64)
    lit_len[lit_len == 0] = 14.0  # unused symbols: discouraging but usable
    dist_len[dist_len == 0] = 14.0
    return lit_len, dist_len


# Candidate sublengths considered by the DP at each match position: the
# full length plus length-code base boundaries (cost steps happen there).
_LEN_CANDIDATES = consts.LENGTH_BASE.tolist()


def _optimal_parse(data, lens, dists, squeeze=native.optimal_parse):
    """Two-round cost-model DP (Zopfli-style squeeze, one candidate match
    per position + code-base sublengths): each round prices the symbols by
    the previous cover's Huffman lengths and ``squeeze`` picks the
    cheapest cover under them. The backward recurrence is sequential, so
    it runs in the host runtime (``native.optimal_parse``); ``_squeeze_py``
    is its Python twin."""
    tok = _greedy_tokens(data, lens, dists)
    lcode = consts.LENGTH_CODE
    lextra = consts.LENGTH_EXTRA
    dcode_t = consts.DIST_CODE
    dextra_t = consts.DIST_EXTRA
    dists_np = np.asarray(dists, dtype=np.int64)
    for _ in range(2):
        lit_len, dist_len = _cost_tables(data, *tok)
        # Cost of emitting length l (code+extra) for l in 3..258, index l-3.
        lcost = (
            lit_len[lcode[consts.MIN_MATCH :]]
            + lextra[lcode[consts.MIN_MATCH :] - 257]
        ).tolist()
        litcost = lit_len[:256].tolist()
        # Per-position distance cost; distances past DEFLATE's table (wide
        # windows for zstd/brotli callers) get a generic log-size estimate.
        in_tbl = dists_np <= consts.WINDOW_SIZE
        dc_arr = np.where(
            in_tbl,
            dist_len[dcode_t[np.minimum(dists_np, consts.WINDOW_SIZE)]]
            + dextra_t[dcode_t[np.minimum(dists_np, consts.WINDOW_SIZE)]],
            5.0 + np.log2(np.maximum(dists_np, 2)),
        )
        tok = squeeze(bytes(data), lens, dists, litcost, lcost, dc_arr, _LEN_CANDIDATES)
    return tok


def _squeeze_py(data, lens, dists, litcost, lcost, dcost, cands):
    """The Python twin of ``native.optimal_parse``: one round's backward
    cost recurrence and the cover it picks."""
    n = len(data)
    data_l = list(data)
    lens_l = np.asarray(lens).tolist()
    dists_l = np.asarray(dists).tolist()
    dc_list = np.asarray(dcost).tolist()
    cost = [0.0] * (n + 1)
    choice = [0] * n
    for i in range(n - 1, -1, -1):
        best = litcost[data_l[i]] + cost[i + 1]
        ch = 0
        L = lens_l[i]
        if L >= 3:
            dc = dc_list[i]
            c = lcost[L - 3] + dc + cost[i + L]
            if c < best:
                best = c
                ch = L
            for lb in cands:
                if lb >= L:
                    break
                c = lcost[lb - 3] + dc + cost[i + lb]
                if c < best:
                    best = c
                    ch = lb
        cost[i] = best
        choice[i] = ch
    # Extract the chosen cover.
    pos_list = []
    tl_list = []
    td_list = []
    i = 0
    while i < n:
        ch = choice[i]
        pos_list.append(i)
        if ch:
            tl_list.append(ch)
            td_list.append(dists_l[i])
            i += ch
        else:
            tl_list.append(0)
            td_list.append(0)
            i += 1
    return (
        np.asarray(pos_list, dtype=np.int64),
        np.asarray(tl_list, dtype=np.int64),
        np.asarray(td_list, dtype=np.int64),
    )


# ---------------------------------------------------------------------------
# Block emission
# ---------------------------------------------------------------------------
def _token_symbols(data, tok_pos, tok_len, tok_dist):
    """litlen / dist symbols + extra fields for a token slice."""
    is_match = tok_len > 0
    lit_syms = np.where(
        is_match, consts.LENGTH_CODE[np.minimum(tok_len, consts.MAX_MATCH)], data[tok_pos]
    ).astype(np.int64)
    dsyms = consts.DIST_CODE[tok_dist].astype(np.int64)
    return is_match, lit_syms, dsyms


def _rle_code_lengths(all_lengths: np.ndarray):
    """RLE the code-length sequence with repeat symbols 16/17/18
    (RFC1951 §3.2.7). Returns (clen_syms, extra_vals, extra_bits) lists."""
    syms: list[int] = []
    extra_vals: list[int] = []
    extra_bits: list[int] = []
    i = 0
    L = len(all_lengths)
    while i < L:
        v = int(all_lengths[i])
        run = 1
        while i + run < L and int(all_lengths[i + run]) == v:
            run += 1
        consumed = run
        if v == 0:
            while run >= 11:
                take = min(run, 138)
                syms.append(18)
                extra_vals.append(take - 11)
                extra_bits.append(7)
                run -= take
            while run >= 3:
                take = min(run, 10)
                syms.append(17)
                extra_vals.append(take - 3)
                extra_bits.append(3)
                run -= take
            syms.extend([0] * run)
            extra_vals.extend([0] * run)
            extra_bits.extend([0] * run)
        else:
            syms.append(v)
            extra_vals.append(0)
            extra_bits.append(0)
            run -= 1
            while run >= 3:
                take = min(run, 6)
                syms.append(16)
                extra_vals.append(take - 3)
                extra_bits.append(2)
                run -= take
            syms.extend([v] * run)
            extra_vals.extend([0] * run)
            extra_bits.extend([0] * run)
        i += consumed
    return syms, extra_vals, extra_bits


def _dynamic_header_fields(lit_lengths: np.ndarray, dist_lengths: np.ndarray):
    """Dynamic-block header (RFC1951 §3.2.7) as (values, nbits) field arrays."""
    hlit = max(257, int(np.nonzero(lit_lengths)[0].max()) + 1)
    nz_d = np.nonzero(dist_lengths)[0]
    hdist = (int(nz_d[-1]) + 1) if len(nz_d) else 1
    all_lengths = np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]])

    syms, extra_vals, extra_bits = _rle_code_lengths(all_lengths)
    clen_freq = np.bincount(np.asarray(syms, dtype=np.int64), minlength=19)
    clen_lengths = length_limited_lengths(clen_freq, 7)
    clen_codes = canonical_codes(clen_lengths)
    clen_rev = reverse_bits(clen_codes, clen_lengths.astype(np.uint32), 7)

    # HCLEN: last transmitted slot (in the permuted order) with nonzero length.
    order_lengths = clen_lengths[consts.CLEN_ORDER]
    nz = np.nonzero(order_lengths)[0]
    hclen = max(4, int(nz[-1]) + 1)

    values: list[int] = [hlit - 257, hdist - 1, hclen - 4]
    nbits: list[int] = [5, 5, 4]
    for i in range(hclen):
        values.append(int(order_lengths[i]))
        nbits.append(3)
    for s, ev, eb in zip(syms, extra_vals, extra_bits):
        values.append(int(clen_rev[s]))
        nbits.append(int(clen_lengths[s]))
        if eb:
            values.append(ev)
            nbits.append(eb)
    return np.asarray(values, dtype=np.uint64), np.asarray(nbits, dtype=np.int64)


def _token_fields(data, tok_pos, tok_len, tok_dist, lit_rev, lit_len_arr, dist_rev, dist_len_arr):
    """Vectorized token → bit-field mapping.

    Each literal is one field (code); each match is two fields
    (lencode|extra, distcode|extra). Fields are interleaved in token order
    with exclusive-prefix-sum placement, then the EOB code is appended.
    """
    is_match = tok_len > 0
    n_tok = len(tok_pos)
    field_count = np.where(is_match, 2, 1)
    start = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(field_count)[:-1]])
    total = int(field_count.sum()) + 1

    values = np.zeros(total, dtype=np.uint64)
    nbits = np.zeros(total, dtype=np.int64)

    lit_mask = ~is_match
    lit_bytes = data[tok_pos[lit_mask]].astype(np.int64)
    values[start[lit_mask]] = lit_rev[lit_bytes]
    nbits[start[lit_mask]] = lit_len_arr[lit_bytes]

    if is_match.any():
        mpos = start[is_match]
        mlens = tok_len[is_match]
        mdists = tok_dist[is_match]
        lsym = consts.LENGTH_CODE[mlens]
        lextra_bits = consts.LENGTH_EXTRA[lsym - 257].astype(np.int64)
        lextra_val = (mlens - consts.LENGTH_BASE[lsym - 257]).astype(np.uint64)
        lcode_len = lit_len_arr[lsym]
        values[mpos] = lit_rev[lsym] | (lextra_val << lcode_len.astype(np.uint64))
        nbits[mpos] = lcode_len + lextra_bits

        dsym = consts.DIST_CODE[mdists]
        dextra_bits = consts.DIST_EXTRA[dsym].astype(np.int64)
        dextra_val = (mdists - consts.DIST_BASE[dsym]).astype(np.uint64)
        dcode_len = dist_len_arr[dsym]
        values[mpos + 1] = dist_rev[dsym] | (dextra_val << dcode_len.astype(np.uint64))
        nbits[mpos + 1] = dcode_len + dextra_bits

    # EOB
    values[-1] = lit_rev[256]
    nbits[-1] = lit_len_arr[256]
    return values, nbits


class DeflateStream:
    """Bit-level deflate block emitter with cross-call remainder carry.

    ``compress(chunk, final)`` consumes one pipeline block of input and
    returns the whole bytes produced so far; partial trailing bits stay
    buffered so consecutive blocks form one continuous bit stream (chunked
    output is byte-identical to one-shot).
    """

    def __init__(self, level: int, strategy: ZlibStrategy,
                 mem_level: int = 8) -> None:
        self.level = level
        self.strategy = strategy
        # zlib memLevel semantics: sizes the match-finder hash (ours:
        # mem_level + 8 hash bits; the default 8 keeps the 16-bit hash).
        self.hash_bits = mem_level + 8
        self.tail_bits = 0
        self.tail_byte = 0
        self.final_emitted = False

    def reset(self) -> None:
        self.tail_bits = 0
        self.tail_byte = 0
        self.final_emitted = False

    # -- low-level field emission -------------------------------------
    def _pack(self, values, nbits) -> bytes:
        out, self.tail_bits, self.tail_byte = pack_bits(
            values, nbits, self.tail_bits, self.tail_byte
        )
        return out

    def align(self) -> bytes:
        """Pad with zero bits to a byte boundary."""
        if self.tail_bits:
            out = bytes([self.tail_byte])
            self.tail_bits = 0
            self.tail_byte = 0
            return out
        return b""

    # -- block emitters -------------------------------------------------
    def _stored_fields(self, data: np.ndarray, final: bool):
        """Stored block(s): header, align, LEN/NLEN, raw bytes. Every block
        after the first starts byte-aligned, since the one before it ends
        with whole bytes, so only the first pads from the carried bits.
        (The reference pads every block from the carried bits, which
        misplaces LEN/NLEN of a stored run past 65,535 bytes that starts
        mid-byte: a stream no inflate accepts.)"""
        pieces = []
        n = len(data)
        offset = 0
        tail_bits = self.tail_bits
        while True:
            take = min(n - offset, 65535)
            last = final and (offset + take == n)
            values = [int(last), 0]
            nbits = [1, 2]
            pad = (8 - ((tail_bits + 3) % 8)) % 8
            tail_bits = 0
            if pad:
                values.append(0)
                nbits.append(pad)
            values += [take, take ^ 0xFFFF]
            nbits += [16, 16]
            pieces.append((np.asarray(values, dtype=np.uint64), np.asarray(nbits, dtype=np.int64)))
            chunk = data[offset : offset + take]
            pieces.append((chunk.astype(np.uint64), np.full(len(chunk), 8, dtype=np.int64)))
            offset += take
            if offset >= n:
                break
        return pieces

    def _huffman_block(self, data, tok_pos, tok_len, tok_dist, final: bool) -> bytes:
        """Choose stored/fixed/dynamic for one token slice and emit it."""
        is_match, lit_syms, dsyms = _token_symbols(data, tok_pos, tok_len, tok_dist)
        lit_freq = np.bincount(lit_syms, minlength=286)
        lit_freq[256] += 1  # EOB
        dist_freq = np.bincount(dsyms[is_match], minlength=30)

        blk_start = int(tok_pos[0]) if len(tok_pos) else 0
        blk_end = (
            int(tok_pos[-1]) + int(max(tok_len[-1], 1)) if len(tok_pos) else 0
        )
        raw_len = blk_end - blk_start

        # Candidate costs (bits).
        fixed_cost = int(
            np.sum(lit_freq * consts.FIXED_LITLEN_LENGTHS[: len(lit_freq)])
            + np.sum(dist_freq * consts.FIXED_DIST_LENGTHS)
            + np.sum(consts.LENGTH_EXTRA[lit_syms[is_match] - 257])
            + np.sum(consts.DIST_EXTRA[dsyms[is_match]])
        ) + 3
        stored_cost = 8 * raw_len + 40 * (-(-max(raw_len, 1) // 65535)) + 7

        if self.strategy is ZlibStrategy.Fixed:
            dyn_cost = 1 << 62
            dyn = None
        else:
            lit_lengths = length_limited_lengths(lit_freq, 15)
            if not dist_freq.any():
                # A dynamic block must still declare >= 1 distance code.
                dist_lengths = np.zeros(30, dtype=np.uint8)
                dist_lengths[0] = 1
            else:
                dist_lengths = length_limited_lengths(dist_freq, 15)
                if int((dist_lengths > 0).sum()) == 1:
                    # Single real dist code: keep it at length 1.
                    dist_lengths = np.where(dist_freq > 0, 1, 0).astype(np.uint8)
            hdr_vals, hdr_bits = _dynamic_header_fields(
                lit_lengths.astype(np.int64), dist_lengths.astype(np.int64)
            )
            dyn_cost = (
                int(hdr_bits.sum())
                + int(np.sum(lit_freq * lit_lengths))
                + int(np.sum(dist_freq * dist_lengths))
                + int(np.sum(consts.LENGTH_EXTRA[lit_syms[is_match] - 257]))
                + int(np.sum(consts.DIST_EXTRA[dsyms[is_match]]))
                + 3
            )
            dyn = (lit_lengths, dist_lengths, hdr_vals, hdr_bits)

        if stored_cost <= min(fixed_cost, dyn_cost):
            pieces = self._stored_fields(data[blk_start:blk_end], final)
            out = bytearray()
            for values, nbits in pieces:
                out.extend(self._pack(values, nbits))
            return bytes(out)

        if fixed_cost <= dyn_cost:
            lit_lengths = consts.FIXED_LITLEN_LENGTHS
            dist_lengths = consts.FIXED_DIST_LENGTHS
            header_vals = np.asarray([int(final), 1], dtype=np.uint64)
            header_bits = np.asarray([1, 2], dtype=np.int64)
        else:
            lit_lengths, dist_lengths, hdr_vals, hdr_bits = dyn
            lit_lengths = lit_lengths.astype(np.int64)
            dist_lengths = dist_lengths.astype(np.int64)
            header_vals = np.concatenate(
                [np.asarray([int(final), 2], dtype=np.uint64), hdr_vals]
            )
            header_bits = np.concatenate([np.asarray([1, 2], dtype=np.int64), hdr_bits])

        lit_codes = canonical_codes(lit_lengths)
        lit_rev = reverse_bits(lit_codes, lit_lengths.astype(np.uint32)).astype(np.uint64)
        dist_codes = canonical_codes(dist_lengths)
        dist_rev = reverse_bits(dist_codes, dist_lengths.astype(np.uint32)).astype(np.uint64)
        tok_vals, tok_bits = _token_fields(
            data,
            tok_pos,
            tok_len,
            tok_dist,
            lit_rev,
            np.asarray(lit_lengths, dtype=np.int64),
            dist_rev,
            np.asarray(dist_lengths, dtype=np.int64),
        )
        values = np.concatenate([header_vals, tok_vals])
        nbits = np.concatenate([header_bits, tok_bits])
        return self._pack(values, nbits)

    # -- public entry ----------------------------------------------------
    def compress(self, chunk: bytes, final: bool) -> bytes:
        """Compress one pipeline block into deflate blocks."""
        data = np.frombuffer(chunk, dtype=np.uint8)
        n = len(data)
        out = bytearray()
        if n == 0:
            if final:
                out.extend(self._emit_empty_final())
            return bytes(out)
        if self.level == 0:
            pieces = self._stored_fields(data, final)
            for values, nbits in pieces:
                out.extend(self._pack(values, nbits))
            if final:
                self.final_emitted = True
            return bytes(out)

        tok_pos, tok_len, tok_dist = tokenize(
            data, self.level, self.strategy, hash_bits=self.hash_bits
        )
        # Split tokens into sub-blocks at ~SUBBLOCK input-byte boundaries so
        # Huffman tables adapt locally (zlib's block granularity).
        boundaries = np.searchsorted(tok_pos, np.arange(SUBBLOCK, n, SUBBLOCK))
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(tok_pos)]])
        slices = [(int(s), int(e)) for s, e in zip(starts, ends) if s < e]
        for bi, (s, e) in enumerate(slices):
            last = final and bi == len(slices) - 1
            out.extend(
                self._huffman_block(data, tok_pos[s:e], tok_len[s:e], tok_dist[s:e], last)
            )
        if final:
            self.final_emitted = True
        return bytes(out)

    def _emit_empty_final(self) -> bytes:
        """Empty final stored block (Finish with no pending input)."""
        values = [1, 0]
        nbits = [1, 2]
        pad = (8 - ((self.tail_bits + 3) % 8)) % 8
        if pad:
            values.append(0)
            nbits.append(pad)
        values += [0, 0xFFFF]
        nbits += [16, 16]
        self.final_emitted = True
        return self._pack(
            np.asarray(values, dtype=np.uint64), np.asarray(nbits, dtype=np.int64)
        )

    def sync_flush(self) -> bytes:
        """Z_SYNC_FLUSH equivalent: empty non-final stored block, leaving the
        stream byte-aligned at a resume point."""
        values = [0, 0]
        nbits = [1, 2]
        pad = (8 - ((self.tail_bits + 3) % 8)) % 8
        if pad:
            values.append(0)
            nbits.append(pad)
        values += [0, 0xFFFF]
        nbits += [16, 16]
        return self._pack(
            np.asarray(values, dtype=np.uint64), np.asarray(nbits, dtype=np.int64)
        )
