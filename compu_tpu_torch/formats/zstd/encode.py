"""Zstandard encoder (RFC 8878): the port's copy of
``compu_tpu/formats/zstd/encode.py``.

Per frame block of up to 128 KiB: a token cover, collapsed into zstd
sequences; Huffman-compressed literals (1- or 4-stream, raw fallback);
sequences FSE-coded with custom normalized tables (predefined, RLE and
repeat modes too); RLE/raw block fallbacks; the optional xxhash64 content
checksum. The cover comes from one of two LZ stages:

* the device route (``device_lz``, the port's default): the shared device
  matcher (``formats/device_lz.py``), one tokenizer call per staged span
  of 8 frame blocks, sliced per block;
* the host route: the reference's host match finders by parse level.
  Below level 9 the greedy/lazy cover of ``deflate_encode.tokenize`` (from
  level 5 with matches reaching into the previous block's window), from
  level 9 the zstd-native cost-model parse (``_zstd_optimal_tokens``);
  from level 12 a chunk's sub-blocks share one chain walk; from level 5
  matches are promoted to repeat offsets (``_promote_rep_offsets``).

With ``device_literals`` the 4-stream literal pack, and with
``device_sequences`` the sequences bitstream, run on the device
(``kernels/zstd_literals.py``, ``kernels/zstd_seq.py``), byte for byte the
host writers' output.

The host stages call the host runtime's loops (``native_enc.py``) where
the reference calls its own: the sequences from a cover of more than 512
tokens, the codes, repeat offsets and (when the sequences do not run on
the device) the bitstream of a section of more than 64 sequences, Huffman
streams of more than 64 bytes, every round of the cost-model parse, and
the repeat-offset promotion of more than 64 sequences. The pure-Python
forms below stay as their twins (``_optimal_dp_py`` for the parse).
"""

from __future__ import annotations

import struct

import numpy as np

from ...ops.huffman import length_limited_lengths
from ...ops.xxhash import xxh64
from ..base import CodecFailure
from ..deflate.deflate_encode import _greedy_tokens, find_matches, find_matches_k, tokenize
from ..deflate.options import ZlibStrategy
from . import native_enc
from .fse import ForwardBitWriter, FseEncodeTable, write_norm_counts
from .huff import HufEncoder, normalize_counts
from . import tables as T

ZSTD_MAGIC = 0xFD2FB528
MAX_BLOCK = 128 * 1024


def _sequences_from_tokens(data, tok_pos, tok_len, tok_dist):
    """Collapse a token cover into zstd sequences (ll, offset, ml) plus the
    literal byte stream. Adjacent same-distance matches merge into one long
    sequence (the shared matcher caps matches at DEFLATE's 258; zstd match
    lengths are unbounded, so merging recovers long runs). Above 512
    tokens the host runtime's loop, whose sequences come as an (n, 3)
    int64 array; else ``_sequences_from_tokens_py``."""
    if len(tok_pos) > 512:
        lits, (ll, off, ml) = native_enc.seq_from_tokens(bytes(data), tok_pos, tok_len, tok_dist)
        return lits, np.stack([ll.astype(np.int64), off.astype(np.int64),
                               ml.astype(np.int64)], axis=1)
    return _sequences_from_tokens_py(data, tok_pos, tok_len, tok_dist)


def _sequences_from_tokens_py(data, tok_pos, tok_len, tok_dist):
    """The Python twin of ``_sequences_from_tokens``: a list of (ll, off,
    ml) tuples."""
    lits = bytearray()
    seqs = []
    pending_lit = 0
    run_start = 0
    for p, l, d in zip(tok_pos, tok_len, tok_dist):
        if l == 0:
            if pending_lit == 0:
                run_start = p
            pending_lit += 1
        else:
            if (
                seqs
                and pending_lit == 0
                and seqs[-1][1] == int(d)
                and seqs[-1][2] + int(l) <= 131074  # ML code 52 ceiling
            ):
                seqs[-1] = (seqs[-1][0], seqs[-1][1], seqs[-1][2] + int(l))
            else:
                lits.extend(data[run_start : run_start + pending_lit])
                seqs.append((pending_lit, int(d), int(l)))
                pending_lit = 0
            run_start = p + l
    if pending_lit:
        lits.extend(data[run_start : run_start + pending_lit])
    return bytes(lits), seqs


# --- zstd-native optimal parse (btopt-style squeeze) -----------------------
# Match lengths 3..258 -> ML code / extra bits (the shared matcher caps at
# DEFLATE's 258; longer runs are recovered by the same-distance merge above).
_ML_CODE_LEN = np.zeros(259, dtype=np.int64)
for _l in range(3, 259):
    _ML_CODE_LEN[_l] = T.ml_code(_l)
_ML_XBITS_LEN = T.ML_BITS[_ML_CODE_LEN]
# Candidate sublengths: every length <= 67 (cost[i+l] varies within a code
# bucket even when the code cost doesn't), then the code-base boundaries.
_ML_SUBLENS = sorted(set(list(range(3, 68)) + [int(b) for b in T.ML_BASE if b <= 258]))


def _parse_effort(level: int):
    """Effort ladder for the high strategies: (pareto slots K, chain-walk
    depth), the btopt/btultra analogue; depth is the dominant ratio
    lever."""
    if level >= 22:
        return 5, 2048
    if level >= 19:
        return 5, 512
    if level >= 15:
        return 5, 128
    if level >= 12:
        return 3, 64
    return 1, 0


def _zstd_optimal_tokens(full: np.ndarray, hist_len: int, level: int,
                         max_dist: int, data_len: int | None = None,
                         matches=None, rep_in=None):
    """Iterated cost-model parse with zstd-native prices: literal cost from
    an 11-bit-capped Huffman estimate, match cost = ML code FSE cost + extra
    bits + OF code cost + offset bits + amortized LL channel cost. Two to
    four Zopfli-style rounds (stats from the previous parse), each one call
    of the host runtime's relax loop (``native_enc.optimal_parse``; its
    twin is ``_optimal_dp_py``). ``full`` includes ``hist_len`` window bytes from previous
    blocks; tokens are returned for the region past the history (distances
    may reach into it — RFC 8878 windows span block boundaries).
    ``data_len`` bounds the parsed region (sub-block splitting);
    ``matches`` injects precomputed pareto candidates over ``full`` so
    split blocks share ONE chain walk."""
    K, depth = _parse_effort(level)
    if matches is None:
        matches = find_matches_k(
            full, min(level, 9), max_dist, K=K, depth=depth,
            deflate_heuristics=False,
        )
    lens_fk, dists_fk = matches
    end = len(full) if data_len is None else hist_len + data_len
    data = full[hist_len:end]
    full = full[:end]
    n = len(data)
    lens_k = np.asarray(lens_fk[hist_len:end], dtype=np.int64)
    dists_k = np.asarray(dists_fk[hist_len:end], dtype=np.int64)
    # Matches must not run past the block end (zstd sequences reproduce
    # exactly one block) — clamp, and drop below the 3-byte minimum.
    room = n - np.arange(n)
    lens_k = np.minimum(lens_k, room[:, None])
    lens_k[lens_k < 3] = 0
    # Longest candidate (slot of max length) seeds the greedy parse.
    top = np.argmax(lens_k, axis=1)
    rows = np.arange(len(lens_k))
    lens = lens_k[rows, top]
    dists = dists_k[rows, top]
    tok = _greedy_tokens(data, lens, dists)
    if n <= 16:
        return tok
    # Extremely repetitive blocks (mean token span > 64 bytes): the greedy
    # cover is already nearly all max-length matches and the per-position
    # sublength DP would grind O(n * |sublens| * rounds) for <0.1% gain.
    if len(tok[0]) * 64 < n:
        return tok
    # Offset codes per candidate (value = offset+3; repeat slots are priced
    # by the channel stats, not per-position). bit_length via searchsorted
    # over powers of two.
    occ_k = np.searchsorted(_POW2, np.maximum(dists_k, 1) + 3, side="right") - 1

    def chan_cost(codes, nsym):
        f = np.bincount(codes, minlength=nsym).astype(np.float64)
        tot = max(f.sum(), 1.0)
        return np.minimum(np.where(f > 0, -np.log2(np.maximum(f, 1) / tot), 15.0), 15.0)

    rounds = 4 if level >= 22 else (3 if level >= 15 else 2)
    for _ in range(rounds):
        lits, seqs = _sequences_from_tokens(data, *tok)
        if len(seqs) == 0:
            break
        seqs = _promote_rep_offsets(full, hist_len, seqs, rep_in)
        lf = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
        if len(lits) >= 32:
            ll_ = length_limited_lengths(lf, 11).astype(np.float64)
            ll_[ll_ == 0] = 12.0
        else:
            ll_ = np.full(256, 8.0)
        sa = np.asarray(seqs, dtype=np.int64)
        of_vals = native_enc.resolve_offsets(sa[:, 0], sa[:, 1], rep_in)[0]
        of_codes = np.searchsorted(_POW2, of_vals, side="right") - 1
        ml_a, ll_a = sa[:, 2], sa[:, 0]
        ml_codes = np.where(
            ml_a < 35, ml_a - 3, np.searchsorted(T.ML_BASE, ml_a, side="right") - 1)
        ll_codes = np.where(
            ll_a < 16, ll_a, np.searchsorted(T.LL_BASE, ll_a, side="right") - 1)
        ofc = chan_cost(of_codes, 32)
        mlc = chan_cost(ml_codes, 53)
        llc = chan_cost(ll_codes, 36)
        # LL channel split: each sequence pays the ll=0 code (the common
        # back-to-back-match case); the surplus (nonzero-run codes + extra
        # bits) is amortized over the literals that create those runs.
        llc0 = float(llc[0])
        ll_tot = float(np.sum(llc[ll_codes] + T.LL_BITS[ll_codes]))
        lit_extra = max(0.0, (ll_tot - len(seqs) * llc0) / max(len(lits), 1))
        mlcost_arr = mlc[_ML_CODE_LEN[3:]] + _ML_XBITS_LEN[3:]  # [l-3]
        dc_arr = ofc[np.clip(occ_k, 0, 31)] + occ_k + llc0  # (n, K)
        # Repeat-offset match price: OF value 1 -> code 0, zero extra bits.
        rep_dc = float(ofc[0]) + llc0
        tok = native_enc.optimal_parse(
            full.tobytes(), hist_len, n, lens_k, dists_k, ll_ + lit_extra, mlcost_arr,
            dc_arr, rep_dc, _ML_SUBLENS, rep_in[0] if rep_in else 1)
    return tok


def _optimal_dp_py(full: bytes, hist_len: int, n: int, lens_k, dists_k, litcost,
                   mlcost_len, dc_k, rep_dc: float, sublens, rep0_init: int):
    """The Python twin of ``native_enc.optimal_parse``: one round's forward
    DP over ``full[hist_len:hist_len + n]`` and its backtrack, as (pos,
    len, dist) int64 arrays.

    Forward DP with arrival rep0 state (btultra-style): a position's best
    path carries the rep0 its predecessor match established, and a
    same-distance (rep0) match is offered as an extra candidate priced at
    the ~1-bit repeat code — this is what makes short matches profitable."""
    K = np.asarray(lens_k).shape[1]
    litcost = np.asarray(litcost).tolist()
    mlcost_len = np.asarray(mlcost_len).tolist()
    dc_k = np.asarray(dc_k).tolist()
    full_l = list(full)
    lens_kl = np.asarray(lens_k).tolist()
    dists_kl = np.asarray(dists_k).tolist()
    data_l = full_l[hist_len:hist_len + n]
    INF = 1e18
    cost = [INF] * (n + 1)
    cost[0] = 0.0
    rep0 = [rep0_init] * (n + 1)
    plen = [0] * (n + 1)
    pdist = [0] * (n + 1)

    def relax(j, c, r, l, d):
        if c < cost[j]:
            cost[j] = c
            rep0[j] = r
            plen[j] = l
            pdist[j] = d

    rep_memo_r = -1
    rep_memo_l = 0
    rep_memo_i = -10
    for i in range(n):
        ci = cost[i]
        r0 = rep0[i]
        # literal step
        relax(i + 1, ci + litcost[data_l[i]], r0, 0, 0)
        # rep0 match measured on the fly (may reach into the history).
        # Carry memo keeps this O(n) on run-heavy data: with the same rep
        # distance, matchlen(i+1) == matchlen(i) - 1 exactly — unless the
        # previous scan hit the cap, where it re-extends from cap-1.
        src = hist_len + i - r0
        if src >= 0:
            dst = hist_len + i
            lmax = min(258, n - i)
            if r0 == rep_memo_r and rep_memo_i == i - 1 and rep_memo_l > 0:
                l = rep_memo_l - 1
                if rep_memo_l >= 258:
                    while l < lmax and full_l[src + l] == full_l[dst + l]:
                        l += 1
                l = min(l, lmax)
            else:
                l = 0
                while l < lmax and full_l[src + l] == full_l[dst + l]:
                    l += 1
            rep_memo_r, rep_memo_l, rep_memo_i = r0, l, i
            if l >= 3:
                relax(i + l, ci + mlcost_len[l - 3] + rep_dc, r0, l, r0)
                for lb in sublens:
                    if lb >= l:
                        break
                    relax(i + lb, ci + mlcost_len[lb - 3] + rep_dc, r0, lb, r0)
        # finder candidates (pareto slots, nearest-first)
        row_l = lens_kl[i]
        row_d = dists_kl[i]
        row_c = dc_k[i]
        prev_l = 2  # shorter sublengths are covered by closer slots
        for k in range(K):
            L = row_l[k]
            if L < 3 or L <= prev_l:
                continue
            D = row_d[k]
            dc = row_c[k]
            relax(i + L, ci + mlcost_len[L - 3] + dc, D, L, D)
            for lb in sublens:
                if lb >= L:
                    break
                if lb <= prev_l:
                    continue
                relax(i + lb, ci + mlcost_len[lb - 3] + dc, D, lb, D)
            prev_l = L
    # Backtrack the chosen cover.
    pos_r, tl_r, td_r = [], [], []
    j = n
    while j > 0:
        l = plen[j]
        if l:
            pos_r.append(j - l)
            tl_r.append(l)
            td_r.append(pdist[j])
            j -= l
        else:
            pos_r.append(j - 1)
            tl_r.append(0)
            td_r.append(0)
            j -= 1
    return (np.asarray(pos_r[::-1], dtype=np.int64),
            np.asarray(tl_r[::-1], dtype=np.int64),
            np.asarray(td_r[::-1], dtype=np.int64))


def _promote_rep_offsets(full: np.ndarray, hist_len: int, seqs, rep=None):
    """Swap a match's offset for a repeat-history distance when the same
    bytes exist there (elementwise compare on the true data is exact even
    for overlapping copies): an OF code drops from ~oc+4 bits to ~1-3.
    Tracks the 3-slot history exactly as the decoder does, including the
    ll==0 slot rotation (decode.py::_execute_sequences); ``rep`` is the
    incoming frame-persistent ring. Above 64 sequences the host runtime's
    loop (``native_enc.promote_rep``), whose result is an (n, 3) array."""
    if len(seqs) > 64:
        return native_enc.promote_rep(full.tobytes(), hist_len, seqs, rep)
    rep = list(rep) if rep is not None else [1, 4, 8]
    pos = hist_len
    out = []
    nfull = len(full)
    for ll, off, ml in seqs:
        pos += ll
        new_off = off
        cands = (rep[0], rep[1], rep[2]) if ll != 0 else (rep[1], rep[2], rep[0] - 1)
        for rd in cands:
            if rd == off:
                break  # already coded as a (cheaper or equal) repeat
            if rd <= 0 or pos - rd < 0 or pos + ml > nfull:
                continue
            if np.array_equal(full[pos - rd : pos - rd + ml], full[pos : pos + ml]):
                new_off = rd
                break
        out.append((ll, new_off, ml))
        # History update, identical to _resolve_offset_values/decoder.
        if ll != 0:
            if new_off == rep[0]:
                val = 1
            elif new_off == rep[1]:
                val = 2
            elif new_off == rep[2]:
                val = 3
            else:
                val = new_off + 3
        else:
            if new_off == rep[1]:
                val = 1
            elif new_off == rep[2]:
                val = 2
            elif new_off == rep[0] - 1 and new_off > 0:
                val = 3
            else:
                val = new_off + 3
        if val > 3:
            rep = [new_off, rep[0], rep[1]]
        else:
            idx = val - 1 + (1 if ll == 0 else 0)
            if idx == 1:
                rep = [new_off, rep[0], rep[2]]
            elif idx >= 2:
                rep = [new_off, rep[0], rep[1]]
        pos += ml
    return out


def _tokens_with_history(full: np.ndarray, hist_len: int, level: int,
                         max_dist: int):
    """Token cover of ``full[hist_len:]`` with matches allowed to reach into
    the history prefix (cross-block window, RFC 8878 §3.1.1.2.2)."""
    if level >= 9:
        return _zstd_optimal_tokens(full, hist_len, level, max_dist)
    lens_f, dists_f = find_matches(full, level, ZlibStrategy.Default, max_dist)
    data = full[hist_len:]
    return _greedy_tokens(data, lens_f[hist_len:], dists_f[hist_len:])


def _literals_section(lits: bytes, reuse: dict | None = None,
                      device=None) -> bytes:
    """Literals section: huffman when profitable, else raw. With ``reuse``
    (stream-state dict), a previous block's tree may be reused treeless
    (Literals_Block_Type 3 — no table description) when it covers the
    current bytes and beats a fresh tree + description. With a ``device``
    the four streams are packed there, else by the host writer."""
    n = len(lits)
    if n >= 32:
        try:
            freqs = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
            enc = HufEncoder(freqs)
            desc = enc.describe()
            lit_type = 2
            prev = reuse.get("huf") if reuse else None
            if prev is not None:
                covered = all(
                    s <= prev.max_symbol and prev.nbits[s] > 0
                    for s in np.nonzero(freqs)[0]
                )
                if covered:
                    prev_bits = int(np.sum(freqs[: prev.max_symbol + 1]
                                           * prev.nbits))
                    new_bits = len(desc) * 8 + int(np.sum(
                        freqs * np.where(
                            np.arange(256) <= enc.max_symbol,
                            np.concatenate([
                                enc.nbits,
                                np.zeros(256 - enc.max_symbol - 1, np.int32),
                            ]),
                            0,
                        )
                    ))
                    if prev_bits <= new_bits:
                        enc = prev
                        desc = b""
                        lit_type = 3
            def commit():
                if reuse is not None and lit_type == 2:
                    reuse["huf"] = enc

            if n <= 1023:
                stream = enc.encode_stream(lits)
                payload = desc + stream
                comp = len(payload)
                if comp < n and comp <= 1023:
                    # size_format 00: single stream, 10+10 bits
                    commit()
                    b0 = lit_type | (0 << 2) | ((n & 0xF) << 4)
                    b1 = (n >> 4) | ((comp & 3) << 6)
                    b2 = comp >> 2
                    return bytes([b0, b1, b2]) + payload
            else:
                per = (n + 3) // 4
                counts = [per, per, per, n - 3 * per]
                chunks = []
                off = 0
                for c in counts:
                    chunks.append(lits[off : off + c])
                    off += c
                if device is not None:
                    # Device 4-stream Huffman pack (byte-identical to the
                    # host writer; kernels/zstd_literals.py).
                    from ...kernels.zstd_literals import encode_streams_device

                    streams = encode_streams_device(chunks, enc.code, enc.nbits, device)
                else:
                    streams = [enc.encode_stream(c) for c in chunks]
                jump = struct.pack(
                    "<HHH", len(streams[0]), len(streams[1]), len(streams[2])
                )
                payload = desc + jump + b"".join(streams)
                comp = len(payload)
                if comp < n:
                    commit()
                    if n <= 16383 and comp <= 16383:
                        # size_format 10: 14+14 bits
                        b0 = lit_type | (2 << 2) | ((n & 0xF) << 4)
                        b1 = (n >> 4) & 0xFF
                        b2 = ((n >> 12) & 3) | ((comp & 0x3F) << 2)
                        b3 = (comp >> 6) & 0xFF
                        return bytes([b0, b1, b2, b3]) + payload
                    # size_format 11: 18+18 bits
                    b0 = lit_type | (3 << 2) | ((n & 0xF) << 4)
                    b1 = (n >> 4) & 0xFF
                    b2 = ((n >> 12) & 0x3F) | ((comp & 3) << 6)
                    b3 = (comp >> 2) & 0xFF
                    b4 = (comp >> 10) & 0xFF
                    return bytes([b0, b1, b2, b3, b4]) + payload
        except CodecFailure:
            pass
    # Raw literals.
    if n < 32:
        if n <= 31:
            return bytes([0 | (0 << 2) | (n << 3)]) + lits
    if n <= 4095:
        b0 = 0 | (1 << 2) | ((n & 0xF) << 4)
        return bytes([b0, n >> 4]) + lits
    b0 = 0 | (3 << 2) | ((n & 0xF) << 4)
    return bytes([b0, (n >> 4) & 0xFF, (n >> 12) & 0xFF]) + lits


def _offset_code(offset_value: int) -> int:
    return int(offset_value).bit_length() - 1


def _fse_bits(freqs, norm, log) -> float:
    """Estimated FSE bits for ``freqs`` occurrences under a normalized
    table (−1 entries are the RFC 'less than 1' probability ≈ 2^-log)."""
    narr = np.asarray(norm, dtype=np.float64)
    p = np.where(narr == -1, 1.0, narr)
    nb = log - np.log2(np.maximum(p, 1.0))
    f = np.asarray(freqs[: len(narr)], dtype=np.float64)
    if np.any((f > 0) & (p <= 0)):
        return float("inf")
    return float(np.sum(f * nb))


class _SeqTable:
    """One sequence channel's chosen coding: RLE / predefined / custom /
    repeat (mode 3 reuses the previous block's table — zero header). The
    choice minimizes estimated bits (header + payload); ``reuse`` carries
    the cross-block stream state keyed by channel name."""

    def __init__(self, codes, default_dist, default_log, max_symbol, max_log,
                 reuse: dict | None = None, chan: str | None = None):
        self.codes = codes
        codes_a = np.asarray(codes, dtype=np.int64)
        freqs = np.bincount(codes_a, minlength=max_symbol + 1)
        uniq = np.nonzero(freqs)[0]
        cands = []  # (bits, mode, header, enc, new_state)
        if len(uniq) == 1:
            cands.append((8.0, 1, bytes([int(codes_a[0])]), None, None))
        norm, log = normalize_counts(freqs, len(codes_a), max_log)
        if norm is not None:
            try:
                enc = FseEncodeTable(norm, log)
                header = write_norm_counts(norm, log)
                cands.append((
                    len(header) * 8 + _fse_bits(freqs, norm, log),
                    2, header, enc, (enc, norm, log),
                ))
            except CodecFailure:
                pass
        dd = np.asarray(default_dist, dtype=np.int64)
        if uniq[-1] < len(dd) and np.all(dd[uniq] != 0):
            denc = FseEncodeTable(default_dist, default_log)
            cands.append((
                _fse_bits(freqs, default_dist, default_log),
                0, b"", denc, (denc, default_dist, default_log),
            ))
        prev = reuse.get(chan) if reuse else None
        if prev is not None:
            penc, pnorm, plog = prev
            pn = np.asarray(pnorm, dtype=np.int64)
            if uniq[-1] < len(pn) and np.all(pn[uniq] != 0):
                cands.append((_fse_bits(freqs, pnorm, plog), 3, b"", penc, prev))
        if not cands:
            raise CodecFailure(299, "cannot code sequence channel")
        bits, self.mode, self.header, self.enc, new_state = min(
            cands, key=lambda t: t[0]
        )
        if reuse is not None:
            reuse[chan] = new_state  # RLE clears it (repeat-after-RLE unsupported)


def _resolve_offset_values(seqs, rep=None):
    """Repeat-offset resolution: mirror the decoder's 3-slot history
    (decode.py::_execute_sequences) so recent distances cost ~1 bit.
    ``rep`` is the incoming ring — it PERSISTS across blocks within a
    frame (decoder state), so multi-block encoders must thread it.
    Returns (OF values (1..3 = repeat slots, else offset+3), final ring)."""
    of_values = []
    rep = list(rep) if rep is not None else [1, 4, 8]
    for ll, off, _ in seqs:
        if ll != 0:
            if off == rep[0]:
                val = 1
            elif off == rep[1]:
                val = 2
            elif off == rep[2]:
                val = 3
            else:
                val = off + 3
        else:
            if off == rep[1]:
                val = 1
            elif off == rep[2]:
                val = 2
            elif off == rep[0] - 1 and off > 0:
                val = 3
            else:
                val = off + 3
        of_values.append(val)
        # History update (identical to the decoder).
        if val > 3:
            rep = [off, rep[0], rep[1]]
        else:
            idx = val - 1 + (1 if ll == 0 else 0)
            if idx == 1:
                rep = [off, rep[0], rep[2]]
            elif idx >= 2:
                rep = [off, rep[0], rep[1]]
            # idx == 0: unchanged
    return of_values, rep


_POW2 = np.left_shift(np.int64(1), np.arange(63, dtype=np.int64))


def _sequences_section(seqs, reuse: dict | None = None, device=None) -> bytes:
    """Sequences section: the count, the three channels' modes and table
    descriptions, and the bitstream, packed on ``device`` when one is
    given, else by the host runtime (more than 64 sequences) or the host
    push loop."""
    n = len(seqs)
    out = bytearray()
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append((n >> 8) + 128)
        out.append(n & 0xFF)
    else:
        out.append(255)
        out.append((n - 0x7F00) & 0xFF)
        out.append((n - 0x7F00) >> 8)
    if n == 0:
        return bytes(out)

    rep_in = reuse.get("rep") if reuse else None
    use_native = n > 64
    if use_native:
        # Vectorised channel codes and the host runtime's repeat-offset
        # resolution (the list forms below are their twins).
        sa = np.asarray(seqs, dtype=np.int64)
        ll_a, off_a, ml_a = sa[:, 0], sa[:, 1], sa[:, 2]
        ll_codes = np.where(
            ll_a < 16, ll_a, np.searchsorted(T.LL_BASE, ll_a, side="right") - 1)
        ml_codes = np.where(
            ml_a < 35, ml_a - 3, np.searchsorted(T.ML_BASE, ml_a, side="right") - 1)
        of_values, rep_out = native_enc.resolve_offsets(ll_a, off_a, rep_in)
        of_codes = np.searchsorted(_POW2, of_values, side="right") - 1
    else:
        ll_codes = [T.ll_code(ll) for ll, _, _ in seqs]
        of_values, rep_out = _resolve_offset_values(seqs, rep_in)
        of_codes = [_offset_code(v) for v in of_values]
        ml_codes = [T.ml_code(ml) for _, _, ml in seqs]
    if reuse is not None:
        reuse["rep"] = rep_out

    ll_t = _SeqTable(ll_codes, T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG,
                     T.MAX_LL_SYMBOL, T.MAX_LL_LOG, reuse, "ll")
    of_t = _SeqTable(of_codes, T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG,
                     T.MAX_OF_SYMBOL, T.MAX_OF_LOG, reuse, "of")
    ml_t = _SeqTable(ml_codes, T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG,
                     T.MAX_ML_SYMBOL, T.MAX_ML_LOG, reuse, "ml")
    out.append((ll_t.mode << 6) | (of_t.mode << 4) | (ml_t.mode << 2))
    out.extend(ll_t.header)
    out.extend(of_t.header)
    out.extend(ml_t.header)

    if device is not None:
        # Device twin of _sequences_bitstream_py: interleaved FSE state
        # scan + bit pack on device, byte-identical (kernels/zstd_seq.py).
        out.extend(_sequences_bitstream_device(
            seqs, ll_codes, ml_codes, of_codes, of_values, ll_t, ml_t, of_t, device))
        return bytes(out)

    if use_native:
        # The host runtime's twin of _sequences_bitstream_py.
        out.extend(native_enc.seq_bitstream(
            ll_codes, ml_codes, of_codes,
            ll_a - T.LL_BASE[ll_codes], T.LL_BITS[ll_codes],
            ml_a - T.ML_BASE[ml_codes], T.ML_BITS[ml_codes],
            of_values - _POW2[of_codes], of_codes, ll_t.enc, ml_t.enc, of_t.enc))
        return bytes(out)

    out.extend(_sequences_bitstream_py(seqs, ll_codes, ml_codes, of_codes, of_values,
                                       ll_t, ml_t, of_t))
    return bytes(out)


def _sequences_bitstream_py(seqs, ll_codes, ml_codes, of_codes, of_values,
                            ll_t, ml_t, of_t) -> bytes:
    """The host push loop of the sequences' bitstream, the twin of
    ``native_enc.seq_bitstream`` and of the device's pack."""
    n = len(seqs)
    # Bitstream: ForwardBitWriter; push order is the exact reverse of the
    # decoder's read order (see decode.py::_execute_sequences).
    w = ForwardBitWriter()
    last = n - 1
    ll_state = ll_t.enc.init_state(ll_codes[last]) if ll_t.enc else None
    ml_state = ml_t.enc.init_state(ml_codes[last]) if ml_t.enc else None
    of_state = of_t.enc.init_state(of_codes[last]) if of_t.enc else None

    def push_extras(i):
        ll, off, ml = seqs[i]
        oc = of_codes[i]
        # reverse of read order (of_x, ml_x, ll_x) -> push ll, ml, of
        w.push(ll - int(T.LL_BASE[ll_codes[i]]), int(T.LL_BITS[ll_codes[i]]))
        w.push(ml - int(T.ML_BASE[ml_codes[i]]), int(T.ML_BITS[ml_codes[i]]))
        w.push(of_values[i] - (1 << oc), oc)

    push_extras(last)
    for i in range(last - 1, -1, -1):
        # Updates are read llu, mlu, ofu after seq i's extras; push reversed:
        # of, ml, ll updates first, then the extras of seq i.
        if of_t.enc:
            of_state = of_t.enc.encode(of_state, of_codes[i], w)
        if ml_t.enc:
            ml_state = ml_t.enc.encode(ml_state, ml_codes[i], w)
        if ll_t.enc:
            ll_state = ll_t.enc.encode(ll_state, ll_codes[i], w)
        push_extras(i)
    # Init-state flushes: decoder reads ll, of, ml first -> push ml, of, ll.
    if ml_t.enc:
        ml_t.enc.flush(ml_state, w)
    if of_t.enc:
        of_t.enc.flush(of_state, w)
    if ll_t.enc:
        ll_t.enc.flush(ll_state, w)
    return w.finish()


def _sequences_bitstream_device(seqs, ll_codes, ml_codes, of_codes,
                                of_values, ll_t, ml_t, of_t, device) -> bytes:
    """Prepare the per-sequence arrays (in numpy, from the host codes'
    lists or the vectorised codes' arrays) and run the device FSE scan +
    pack. The pack's fields are 4-byte lanes, so an offset's extra field
    may hold at most 24 bits (offset code 24, a window of ~2^24). The
    reference then takes the host writer; the port raises. Device-LZ
    offsets stay at or below MAX_BLOCK + 3 (code 17)."""
    sa = np.asarray(seqs, dtype=np.int64).reshape(-1, 3)
    ll_codes, ml_codes, of_codes, of_values = (
        np.asarray(a, dtype=np.int64) for a in (ll_codes, ml_codes, of_codes, of_values))
    of_xb = np.searchsorted(_POW2, of_values, side="right") - 1  # _offset_code, vectorised
    if len(of_xb) and of_xb.max() > 24:
        raise ValueError(f"offset code {of_xb.max()} exceeds the device pack's 24 bits")
    ll_x = sa[:, 0] - T.LL_BASE[ll_codes]
    ll_xbits = T.LL_BITS[ll_codes]
    ml_x = sa[:, 2] - T.ML_BASE[ml_codes]
    ml_xbits = T.ML_BITS[ml_codes]
    of_x = of_values - _POW2[of_xb]
    from ...kernels.zstd_seq import encode_sequences_device

    return encode_sequences_device(
        ll_codes, ml_codes, of_codes, ll_x, ml_x, of_x,
        ll_xbits, ml_xbits, of_xb, ll_t.enc, ml_t.enc, of_t.enc, device)


def compress_block(data: bytes, level: int = 3, max_dist: int = MAX_BLOCK,
                   tokenizer=None, history: bytes = b"", reuse: dict | None = None,
                   matches=None, device_literals: bool = False,
                   device_sequences: bool = False, device=None,
                   block_max: int = MAX_BLOCK) -> bytes:
    """One zstd block body (compressed type), or raw/RLE when better.
    Returns the full block including its 3-byte header. ``tokenizer(data)``
    gives the block's token cover where one is given (the device route);
    else the host route parses at ``level``, its matches reaching
    ``max_dist`` back, into ``history`` too (the window tail of previous
    blocks: the decoder's window spans block boundaries), or over the
    shared chain walk ``matches``. The literals and the sequences
    bitstream are packed on ``device`` where
    ``device_literals``/``device_sequences`` ask for it. ``block_max`` is
    the frame's Block_Maximum_Size, min(window, 128 KiB)."""
    n = len(data)
    if not 0 < n <= block_max:
        raise ValueError(f"a block holds 1..{block_max} bytes, got {n}")

    def header(btype, size, last=0):
        h = last | (btype << 1) | (size << 3)
        return struct.pack("<I", h)[:3]

    if data.count(data[0]) == n:  # RLE
        return header(1, n) + data[:1]

    arr = np.frombuffer(data, dtype=np.uint8)
    if tokenizer is not None:
        tok_pos, tok_len, tok_dist = tokenizer(data)
    elif history and level < 9:
        full = np.frombuffer(history + data, dtype=np.uint8)
        tok_pos, tok_len, tok_dist = _tokens_with_history(full, len(history), level, max_dist)
    elif history or level >= 9 or matches is not None:
        full = np.frombuffer(history + data, dtype=np.uint8) if history else arr
        tok_pos, tok_len, tok_dist = _zstd_optimal_tokens(
            full, len(history), level, max_dist, matches=matches,
            rep_in=reuse.get("rep") if reuse else None,
        )
    else:
        tok_pos, tok_len, tok_dist = tokenize(arr, min(level, 9), ZlibStrategy.Default, max_dist)
    lits, seqs = _sequences_from_tokens(arr, tok_pos, tok_len, tok_dist)
    local = dict(reuse) if reuse is not None else None
    if len(seqs) and level >= 5 and tokenizer is None:
        fullarr = np.frombuffer(history + data, dtype=np.uint8) if history else arr
        seqs = _promote_rep_offsets(fullarr, len(history), seqs,
                                    local.get("rep") if local else None)
    try:
        body = (_literals_section(lits, local,
                                  device=device if device_literals else None)
                + _sequences_section(seqs, local,
                                     device=device if device_sequences else None))
    except CodecFailure:
        body = None
    if body is None or len(body) >= n:
        # Raw block: decoder entropy state is untouched, so drop the
        # tentative reuse updates.
        return header(0, n) + data
    if reuse is not None:
        reuse.clear()
        reuse.update(local)
    return header(2, len(body)) + body


def _slice_token_cover(tok_pos, tok_len, tok_dist, off: int, end: int):
    """Block-local view [off, end) of a chunk-level token cover, positions
    rebased to the block. Matches crossing either boundary are split: the
    in-block fragment keeps its distance (still valid — the distance was
    legal at the match's earlier start, and the decoder's window spans
    frame blocks); fragments under MIN_MATCH become literal tokens."""
    tok_pos = np.asarray(tok_pos, dtype=np.int64)
    tok_len = np.asarray(tok_len, dtype=np.int64)
    tok_dist = np.asarray(tok_dist, dtype=np.int64)
    sel = (tok_pos < end) & (tok_pos + np.maximum(tok_len, 1) > off)
    p = tok_pos[sel]
    l = tok_len[sel]
    d = tok_dist[sel]
    is_m = l > 0
    new_p = np.maximum(p, off)
    new_l = np.where(is_m, np.minimum(p + l, end) - new_p, 0)
    keep_m = new_l >= 3
    small = is_m & ~keep_m  # 1-2 byte boundary fragments -> literals
    lit1 = new_p[~is_m]
    sp, sl = new_p[small], new_l[small]
    if len(sp):
        tot = int(sl.sum())
        lit2 = np.repeat(sp, sl) + (np.arange(tot)
                                    - np.repeat(np.cumsum(sl) - sl, sl))
    else:
        lit2 = np.zeros(0, np.int64)
    mp, ml, md = new_p[keep_m], new_l[keep_m], d[keep_m]
    nlit = len(lit1) + len(lit2)
    pos = np.concatenate([lit1, lit2, mp])
    ln = np.concatenate([np.zeros(nlit, np.int64), ml])
    dist = np.concatenate([np.zeros(nlit, np.int64), md])
    order = np.argsort(pos, kind="stable")
    return pos[order] - off, ln[order], dist[order]



class ZstdStreamEncoder:
    """Frame-level streaming encoder (hooks for the pipeline backend).
    Every frame block holds at most ``block_max = min(2^window_log,
    MAX_BLOCK)`` bytes, RFC 8878's Block_Maximum_Size (the reference cuts
    at MAX_BLOCK whatever the window, which stock zstd rejects below
    window_log 17); at window_log >= 17 the frames are the reference's.

    With ``device_lz`` (the route ``ZstdOptions`` defaults to): one device
    tokenizer call per ``tokenizer_span`` bytes staged, one frame block per
    ``block_max`` slice of its cover; matches stay within
    ``min(2^window_log - 1, MAX_BLOCK)``, so distances across frame blocks
    are legal zstd (the decoder's window spans blocks), and ``level`` and
    ``strategy`` are not read. Without it, the host route parses each
    block at ``parse_level`` (the level, or the strategy's rung). ``device``
    (CUDA by default) runs the tokenizer and the device entropy stages; a
    host-route encoder without ``device_literals`` or ``device_sequences``
    touches no device."""

    #: Strategy -> effective parse level (libzstd ZSTD_c_strategy override
    #: semantics, reference src/encoder/zstd.rs:121): the strategy picks the
    #: match-finder/parse ladder rung regardless of level.
    _STRATEGY_PARSE_LEVEL = {
        "Fast": 1, "DFast": 3, "Greedy": 4, "Lazy": 6, "Lazy2": 8,
        "BtLazy2": 10, "BtOpt": 15, "BtUltra": 19, "BtUltra2": 22,
    }

    def __init__(self, level: int = 3, checksum: bool = True, window_log: int = 17,
                 device_lz: bool = True, strategy=None, device_literals: bool = False,
                 device_sequences: bool = False, device=None) -> None:
        # Effective parse level: strategy overrides; level 0 is the default
        # ladder rung (3); negative levels all take the fastest greedy rung.
        if strategy is not None and strategy.name != "Default":
            self.parse_level = self._STRATEGY_PARSE_LEVEL[strategy.name]
        elif level == 0:
            self.parse_level = 3
        elif level < 0:
            self.parse_level = 1
        else:
            self.parse_level = level
        self.checksum = checksum
        self.window_log = window_log
        self.block_max = min(MAX_BLOCK, 1 << window_log)
        self.device_literals = device_literals
        self.device_sequences = device_sequences
        self.device = None
        self.tokenizer = None
        if device_lz or device_literals or device_sequences:
            import torch

            self.device = torch.device("cuda" if device is None else device)
        if device_lz:
            from ..device_lz import DeviceTokenizer

            # 8 frame blocks per tokenizer call: one transfer round trip per MiB.
            self.tokenizer_span = 8 * MAX_BLOCK
            self.tokenizer = DeviceTokenizer(
                self.tokenizer_span, min((1 << window_log) - 1, MAX_BLOCK),
                device=self.device)
        self.reset()

    def reset(self) -> None:
        self._hash_buf = bytearray()
        self._window = b""
        self._reuse: dict = {}

    def header(self) -> bytes:
        fhd = 0
        if self.checksum:
            fhd |= 0x04
        # No content size (streaming), window descriptor present.
        exponent = self.window_log - 10
        wd = exponent << 3
        return struct.pack("<IBB", ZSTD_MAGIC, fhd, wd)

    def _block(self, data: bytes, final: bool, **route) -> bytes:
        blob = compress_block(data, self.parse_level, reuse=self._reuse,
                              device_literals=self.device_literals,
                              device_sequences=self.device_sequences,
                              device=self.device, block_max=self.block_max, **route)
        if final:
            blob = bytes([blob[0] | 1]) + blob[1:]
        return blob

    def compress_chunk(self, data: bytes, final: bool) -> bytes:
        """Compress a staged chunk (up to ``tokenizer_span`` bytes on the
        device route, ``block_max`` on the host route) as one or more frame
        blocks.

        On the host route, levels from 12 split a chunk of more than 48 KiB
        into 32 KiB (level 15 on) or 64 KiB sub-blocks over one chain walk:
        per-block entropy tables adapt locally (the window still spans
        blocks, and repeat-mode tables / treeless literals reuse state when
        a block's statistics don't change)."""
        if self.checksum:
            self._hash_buf.extend(data)
        if not data:
            # Empty final block (raw, size 0).
            return struct.pack("<I", 1 | (0 << 1) | 0)[:3]
        blk = self.block_max
        if self.tokenizer is not None:
            if len(data) <= blk:
                return self._block(data, final, tokenizer=self.tokenizer)
            # One device tokenizer call over the whole staged chunk, then one
            # frame block per ``block_max`` slice of the token cover.
            out = bytearray()
            tok_pos, tok_len, tok_dist = self.tokenizer(data)
            for off in range(0, len(data), blk):
                end = min(off + blk, len(data))
                sub = _slice_token_cover(tok_pos, tok_len, tok_dist, off, end)
                out.extend(self._block(data[off:end], final and end >= len(data),
                                       tokenizer=lambda d, s=sub: s))
            return bytes(out)
        wmax = (1 << self.window_log) - 1
        if self.parse_level >= 12 and len(data) > 49152:
            bs = min(32768 if self.parse_level >= 15 else 65536, blk)
            # ONE chain walk over (window + whole chunk); every sub-block
            # parses against slices of it (the DP clamps lengths to its own
            # block end), instead of re-hashing the history per block.
            window0 = self._window
            gfull = np.frombuffer(window0 + data, dtype=np.uint8)
            K, depth = _parse_effort(self.parse_level)
            gmatches = find_matches_k(gfull, 9, min(wmax, len(gfull)), K=K, depth=depth,
                                      deflate_heuristics=False)
            out = bytearray()
            for off in range(0, len(data), bs):
                sub = data[off: off + bs]
                hist = window0 + data[:off]
                out.extend(self._block(sub, final and off + bs >= len(data),
                                       max_dist=min(wmax, len(hist) + len(sub)),
                                       history=hist, matches=gmatches))
                self._window = (self._window + sub)[-min(wmax, MAX_BLOCK):]
            return bytes(out)
        return self._compress_one(data, final)

    def _compress_one(self, data: bytes, final: bool) -> bytes:
        """One host-route frame block. Levels from 5 match into the window
        (capped at one MAX_BLOCK of history to bound the re-hash cost);
        levels up to 4 stay block-local for speed, like zstd's fast
        strategies."""
        wmax = (1 << self.window_log) - 1
        history = self._window if self.parse_level >= 5 else b""
        blob = self._block(data, final, max_dist=min(wmax, len(history) + len(data)),
                           history=history)
        self._window = (self._window + data)[-min(wmax, MAX_BLOCK):]
        return blob

    def trailer(self) -> bytes:
        if self.checksum:
            return struct.pack("<I", xxh64(bytes(self._hash_buf)) & 0xFFFFFFFF)
        return b""
