"""The plain reference that decides ``correct``: a block-parallel DEFLATE
stream and its block index, judged by what they say.

It holds what an encode returned to the input the benchmark made:

* the stream's header and trailer (RFC 1952 for gzip, RFC 1950 for zlib):
  the checksum and the length of the whole input, worked out here;
* every block's bytes (RFC 1951), decoded on their own, starting at the
  offset the index gives, and held to the block's input byte for byte;
  each block ends in an empty stored block (a sync flush), so the next
  one starts on a byte;
* the closing block after the last block, and nothing after the trailer;
* the index: one entry a block of ``block_size`` input bytes, offsets that
  follow each other from the header on, and each block's segment start
  bits (``segment_bits``: bits 0..23 the bit in the block at which the
  first token at or after the segment's first byte starts, bits 24..31
  how far the previous segment's last token runs into the segment, -1
  for every segment of a stored block).

A Huffman block is decoded segment by segment, all segments of a stream
at once in NumPy: a lane starts at its segment's claimed bit and output
position, every literal is compared with the input, every match's source
with the bytes it stands for, and each lane's last token has to end
exactly where the next lane starts, the last one on the block's
end-of-block code. So a stream passes only if it decodes to the input and
its index locates every segment.

The level the configuration states is held too, on a sample of each
stream's blocks: the matcher it names (``lex_candidates``) is worked out
again from the input, and every match token the stream decodes to in a
sampled block has to be at least as long as what that matcher finds at
its position, cut at the block's and the segment's end. A shallower or
narrower search than the level's leaves shorter matches. The module
imports NumPy and the standard library (``zlib`` for CRC-32 and Adler-32,
and for a second decode of each stream as a witness) and nothing of the
program.
"""

from __future__ import annotations

import zlib

import numpy as np

SEG = 128            # input bytes a segment
LOOKUP_BITS = 15     # the longest DEFLATE code
WINDOW = 32768       # the farthest a match may reach back

LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
                     59, 67, 83, 99, 115, 131, 163, 195, 227, 258], np.int64)
LEN_EXTRA = np.array([0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0],
                     np.int64)
DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
                      513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
                      24577], np.int64)
DIST_EXTRA = np.array([0, 0, 0, 0] + [k for k in range(1, 14) for _ in (0, 1)], np.int64)
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
FIXED_DIST = [5] * 30

#: The counts ``judge`` returns; each is 0 for a correct stream.
COUNTS = ("framing", "blocks", "segments", "wrong_bytes", "witness", "short_matches")


class Malformed(ValueError):
    """The bytes do not say what DEFLATE lets them say."""


class _Bits:
    """LSB-first bit reader over a byte string (RFC 1951, 3.1.1)."""

    def __init__(self, buf: bytes, bit: int = 0):
        self.buf = bytes(buf) + bytes(8)
        self.end = 8 * len(buf)
        self.bit = bit

    def take(self, n: int) -> int:
        if self.bit + n > self.end:
            raise Malformed("read past the end of the block")
        q = self.bit >> 3
        v = int.from_bytes(self.buf[q:q + 4], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def align(self) -> None:
        self.bit = (self.bit + 7) & ~7


def _counts_symbols(lens):
    """Per-length code counts and the symbols in canonical order; raises on
    an oversubscribed code (an incomplete one decodes until a missing code
    is read)."""
    counts = [0] * 16
    for n in lens:
        counts[n] += 1
    counts[0] = 0
    left = 1
    for n in range(1, 16):
        left = (left << 1) - counts[n]
        if left < 0:
            raise Malformed("oversubscribed code")
    symbols = [s for n in range(1, 16) for s, m in enumerate(lens) if m == n]
    return counts, symbols


def _decode_one(bits: _Bits, counts, symbols) -> int:
    """One symbol of a canonical code, a bit at a time."""
    code = first = index = 0
    for n in range(1, 16):
        code |= bits.take(1)
        count = counts[n]
        if code - count < first:
            return symbols[index + code - first]
        index += count
        first = (first + count) << 1
        code <<= 1
    raise Malformed("no code of 15 bits or fewer")


def _read_dynamic(bits: _Bits):
    """The code lengths of a dynamic block's header (RFC 1951, 3.2.7)."""
    hlit, hdist, hclen = bits.take(5) + 257, bits.take(5) + 1, bits.take(4) + 4
    if hlit > 286 or hdist > 30:
        raise Malformed("too many codes")
    cl = [0] * 19
    for i in range(hclen):
        cl[CL_ORDER[i]] = bits.take(3)
    counts, symbols = _counts_symbols(cl)
    lens: list[int] = []
    while len(lens) < hlit + hdist:
        sym = _decode_one(bits, counts, symbols)
        if sym < 16:
            lens.append(sym)
        elif sym == 16:
            if not lens:
                raise Malformed("repeat with no length before it")
            lens += [lens[-1]] * (3 + bits.take(2))
        else:
            lens += [0] * ((3 + bits.take(3)) if sym == 17 else (11 + bits.take(7)))
    if len(lens) != hlit + hdist:
        raise Malformed("code lengths overrun")
    lit, dist = lens[:hlit], lens[hlit:]
    if lit[256] == 0:
        raise Malformed("no end-of-block code")
    return lit, dist


def lookup_table(lens) -> np.ndarray:
    """(2^15,) int32: for the next 15 stream bits, the symbol they start
    with and its code length (``sym | len << 16``), -1 where no code
    fits."""
    _counts_symbols(lens)
    tab = np.full(1 << LOOKUP_BITS, -1, np.int32)
    counts = np.bincount(np.asarray(lens, np.int64), minlength=16)
    counts[0] = 0
    nxt, code = [0] * 16, 0
    for n in range(1, 16):
        code = (code + int(counts[n - 1])) << 1
        nxt[n] = code
    for sym, n in enumerate(lens):
        if n:
            c = nxt[n]
            nxt[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            tab[rev::1 << n] = sym | (n << 16)
    return tab


def _stored_run(blob: bytes, bits: _Bits, first_header_read: bool) -> bytes:
    """Stored blocks from ``bits`` to the end of ``blob``; every one not
    final. Returns their bytes; the last has to be empty (the flush)."""
    out = bytearray()
    last_len = None
    while True:
        if not first_header_read:
            if bits.bit >= bits.end:
                break
            if bits.take(1) or bits.take(2) != 0:
                raise Malformed("a final or non-stored block where stored blocks run")
        first_header_read = False
        bits.align()
        q = bits.bit >> 3
        if q + 4 > len(blob):
            raise Malformed("stored header past the end")
        n, nn = int.from_bytes(blob[q:q + 2], "little"), int.from_bytes(blob[q + 2:q + 4], "little")
        if n ^ nn != 0xFFFF or q + 4 + n > len(blob):
            raise Malformed("bad stored length")
        out += blob[q + 4:q + 4 + n]
        bits.bit = 8 * (q + 4 + n)
        last_len = n
    if last_len != 0:
        raise Malformed("the block does not end in an empty stored block")
    return bytes(out)


def _parse_header(stream: bytes, mode: str) -> int:
    """The header's length; raises if it is not a valid header of ``mode``."""
    if mode == "gzip":
        if len(stream) < 18 or stream[:3] != b"\x1f\x8b\x08" or stream[3] & 0xE0:
            raise Malformed("not a gzip member header")
        flg, pos = stream[3], 10
        if flg & 4:
            pos += 2 + int.from_bytes(stream[pos:pos + 2], "little")
        for bit in (8, 16):
            if flg & bit:
                end = stream.find(b"\0", pos)
                if end < 0:
                    raise Malformed("unterminated header string")
                pos = end + 1
        if flg & 2:
            if int.from_bytes(stream[pos:pos + 2], "little") != zlib.crc32(stream[:pos]) & 0xFFFF:
                raise Malformed("header crc")
            pos += 2
        return pos
    if mode == "zlib":
        if (len(stream) < 6 or stream[0] & 15 != 8 or stream[0] >> 4 > 7
                or ((stream[0] << 8) | stream[1]) % 31 or stream[1] & 0x20):
            raise Malformed("not a zlib header")
        return 2
    raise ValueError(f"unknown framing {mode!r}")


def _trailer(data: bytes, mode: str) -> bytes:
    if mode == "gzip":
        return (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little") + \
            (len(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return (zlib.adler32(data) & 0xFFFFFFFF).to_bytes(4, "big")


def _closing_ok(buf: bytes) -> bool:
    """The blocks between the last indexed block and the trailer: only
    empty stored or empty fixed blocks, the last final, ending on the
    buffer's last byte."""
    bits = _Bits(buf)
    try:
        while True:
            final, kind = bits.take(1), bits.take(2)
            if kind == 0:
                bits.align()
                if bits.take(16) != 0 or bits.take(16) != 0xFFFF:
                    return False
            elif kind != 1 or bits.take(7) != 0:
                return False
            if final:
                bits.align()
                return bits.bit == bits.end
    except Malformed:
        return False


class _Lanes:
    """The segment lanes of one stream's Huffman blocks, gathered block by
    block and walked together."""

    def __init__(self):
        self.cols = {k: [] for k in ("bit", "pos", "tgt", "exp", "gb", "tab", "blk")}
        self.lit_tabs: list[np.ndarray] = []
        self.dist_tabs: list[np.ndarray] = []
        self.blocks: list[tuple] = []  # (block index, blob, rl, off, gb)
        #: Every match token the walk decoded: (input position, length).
        self.matches = (np.zeros(0, np.int64), np.zeros(0, np.int64))

    def add(self, i, blob, off, gb, rl, lit, dist, hdr_end, seg) -> int:
        """Lanes of block ``i``; returns the bad segments found before any
        walk (a first lane away from the header's end)."""
        sa = -(-rl // SEG)
        sb = seg[:sa].astype(np.int64) & 0xFFFFFFFF
        bit, ov = sb & 0xFFFFFF, sb >> 24
        s = np.arange(sa, dtype=np.int64)
        tgt = np.minimum((s + 1) * SEG + np.append(ov[1:], 0), rl)
        tgt[-1] = rl
        exp = np.append(8 * off + bit[1:], -1)
        t = len(self.lit_tabs)
        self.lit_tabs.append(lookup_table(lit))
        self.dist_tabs.append(lookup_table(dist))
        for k, v in (("bit", 8 * off + bit), ("pos", s * SEG + ov), ("tgt", tgt), ("exp", exp),
                     ("gb", np.full(sa, gb)), ("tab", np.full(sa, t)), ("blk", np.full(sa, i))):
            self.cols[k].append(np.asarray(v, np.int64))
        self.blocks.append((i, blob, rl, off, gb))
        return int(bit[0] != hdr_end or ov[0] != 0)

    def walk(self, stream: bytes, inp: np.ndarray, nblocks: int):
        """Decode every lane. Returns (bad lanes a block, wrong bytes a
        block, blocks whose end-of-block or flush is wrong)."""
        bad_lanes = np.zeros(nblocks, np.int64)
        wrong = np.zeros(nblocks, np.int64)
        bad_end = np.zeros(nblocks, np.int64)
        if not self.blocks:
            return bad_lanes, wrong, bad_end
        c = {k: np.concatenate(v) for k, v in self.cols.items()}
        lit_tab = np.concatenate(self.lit_tabs)
        dist_tab = np.concatenate(self.dist_tabs)
        raw = np.frombuffer(stream + bytes(16), np.uint8)
        # w64[q]: the 8 stream bytes from byte q, little-endian.
        w64 = np.ndarray((len(stream) + 8,), "<u8", raw, 0, (1,))
        bit, pos, tgt, gb = c["bit"], c["pos"].copy(), c["tgt"], c["gb"]
        tb = c["tab"] << LOOKUP_BITS
        bit = bit.copy()
        bad = np.zeros(len(bit), bool)
        bad |= (bit < 0) | (bit >= 8 * len(stream)) | (pos > tgt)
        m_at, m_len, m_dist = [], [], []
        act = np.nonzero(~bad & (pos < tgt))[0]
        mask57 = np.uint64((1 << 57) - 1)
        while act.size:
            b, p, base = bit[act], pos[act], tb[act]
            win = ((w64[b >> 3] >> (b & 7).astype(np.uint64)) & mask57).astype(np.int64)
            e = lit_tab[base + (win & 0x7FFF)].astype(np.int64)
            sym, cl = e & 0xFFFF, np.maximum(e >> 16, 0)
            lit = (e >= 0) & (sym < 256)
            is_len = (e >= 0) & (sym >= 257) & (sym <= 285)
            li = np.clip(sym - 257, 0, 28)
            le = LEN_EXTRA[li]
            mlen = LEN_BASE[li] + ((win >> cl) & ((1 << le) - 1))
            w2 = win >> (cl + le)
            d = dist_tab[base + (w2 & 0x7FFF)].astype(np.int64)
            dsym, dl = d & 0xFFFF, np.maximum(d >> 16, 0)
            ds = np.clip(dsym, 0, 29)
            de = DIST_EXTRA[ds]
            dist = DIST_BASE[ds] + ((w2 >> dl) & ((1 << de) - 1))
            match = is_len & (d >= 0) & (dsym < 30) & (dist <= p)
            good = lit | match
            gpos = gb[act] + p
            lp = gpos[lit]
            np.add.at(wrong, c["blk"][act[lit]], (inp[lp] != sym[lit]).astype(np.int64))
            m_at.append(gpos[match])
            m_len.append(mlen[match])
            m_dist.append(dist[match])
            bit[act] = b + np.where(lit, cl, cl + le + dl + de)
            pos[act] = p + np.where(lit, 1, mlen)
            bad[act[~good]] = True
            act = act[good & (pos[act] < tgt[act])]
        bad |= pos != tgt
        bad |= (c["exp"] >= 0) & (bit != c["exp"])
        np.add.at(bad_lanes, c["blk"], bad.astype(np.int64))
        if m_at:
            at, ln, dist = (np.concatenate(v) for v in (m_at, m_len, m_dist))
            self.matches = at, ln
            starts = np.cumsum(ln) - ln
            dst = np.repeat(at, ln) + (np.arange(int(ln.sum())) - np.repeat(starts, ln))
            src = dst - np.repeat(dist, ln)
            ok = dst < len(inp)
            diff = np.ones(len(dst), bool)
            diff[ok] = inp[dst[ok]] != inp[src[ok]]
            blk_of = np.searchsorted(np.asarray([g for *_, g in self.blocks]), np.minimum(
                at, len(inp) - 1), side="right") - 1
            np.add.at(wrong, np.asarray([i for i, *_ in self.blocks])[np.repeat(blk_of, ln)],
                      diff.astype(np.int64))
        # The last lane of each block ends on the end-of-block code, then
        # the flush.
        last = np.nonzero(c["exp"] < 0)[0]
        for lane, (i, blob, rl, off, gb_) in zip(last, self.blocks):
            try:
                if bad[lane]:
                    raise Malformed("last lane")
                bits = _Bits(blob, int(bit[lane]) - 8 * off)
                q = bits.bit >> 3
                win = int.from_bytes(bits.buf[q:q + 4], "little") >> (bits.bit & 7)
                e = int(lit_tab[(int(c["tab"][lane]) << LOOKUP_BITS) + (win & 0x7FFF)])
                if e < 0 or e & 0xFFFF != 256:
                    raise Malformed("no end-of-block code after the last token")
                bits.take(e >> 16)
                _stored_run(blob, bits, False)
            except Malformed:
                bad_end[i] = 1
        return bad_lanes, wrong, bad_end


def lex_candidates(rows: np.ndarray, *, wcap: int, depth: int, keys: int,
                   max_dist: int = WINDOW) -> np.ndarray:
    """The longest match the level's lexicographic matcher finds at each
    position of each block: (k, N) uint8 blocks -> (k, N) int16 lengths.

    Each position's window is its ``wcap`` bytes (wrapping to the block's
    front past its end). Positions sort stably by the window's first
    ``keys`` 4-byte words; a position's candidates are the ``depth``
    positions before it and the ``depth`` after it in that order, each
    matching the length of the common prefix of the windows between them
    (the least of the neighbours' common prefixes on the way), and a
    candidate counts only where it lies 1 to ``max_dist`` bytes earlier in
    the block."""
    k, n = rows.shape
    if wcap % 4 or not 4 <= wcap <= 32 or keys not in (1, 2) or depth < 1:
        raise ValueError(f"no lexicographic matcher of wcap {wcap}, keys {keys}, depth {depth}")
    r32 = rows.astype(np.uint32)
    words = np.stack([(np.roll(r32, -4 * j, -1) << 24) | (np.roll(r32, -4 * j - 1, -1) << 16)
                      | (np.roll(r32, -4 * j - 2, -1) << 8) | np.roll(r32, -4 * j - 3, -1)
                      for j in range(wcap // 4)], 1)     # (k, wcap / 4, n), big-endian
    key = words[:, 0].astype(np.uint64)
    if keys == 2:
        key = (key << np.uint64(32)) | words[:, 1]
    order = np.argsort(key, axis=-1, kind="stable")
    ws = np.take_along_axis(words, order[:, None, :], axis=-1)
    x = ws[:, :, 1:] ^ ws[:, :, :-1]
    lead = ((x <= 0xFFFFFF).astype(np.int8) + (x <= 0xFFFF) + (x <= 0xFF) + (x == 0))
    common = lead[:, 0].copy()
    for j in range(1, wcap // 4):
        common += np.where(common == 4 * j, lead[:, j], 0).astype(np.int8)
    adj = np.zeros((k, n), np.int8)                        # adj[i]: sorted i-1 and i
    adj[:, 1:] = common
    ps = order.astype(np.int32)
    best = np.zeros((k, n), np.int8)
    back = adj.copy()                                      # min adj[i-d+1..i]
    fwd = np.zeros((k, n), np.int8)                        # min adj[i+1..i+d]
    fwd[:, :-1] = adj[:, 1:]
    for d in range(1, min(depth, n - 1) + 1):
        dist = ps[:, d:] - ps[:, :-d]
        ok = (dist > 0) & (dist <= max_dist)
        np.maximum(best[:, d:], np.where(ok, back[:, d:], 0), out=best[:, d:])
        ok = (dist < 0) & (dist >= -max_dist)
        np.maximum(best[:, :-d], np.where(ok, fwd[:, :-d], 0), out=best[:, :-d])
        np.minimum(back[:, d:], adj[:, :-d], out=back[:, d:])
        if d + 1 < n:
            np.minimum(fwd[:, :-d - 1], adj[:, d + 1:], out=fwd[:, :-d - 1])
    cand = np.empty((k, n), np.int16)
    np.put_along_axis(cand, order, best.astype(np.int16), axis=-1)
    return cand


def short_matches(inp: np.ndarray, at: np.ndarray, ln: np.ndarray, blocks, *, block_size: int,
                  matcher: dict) -> int:
    """Match tokens of the given blocks shorter than the level's matcher
    finds at their position, cut at the block's end and the segment's.
    ``at``, ``ln``: every decoded match token's input position and length."""
    blocks = np.asarray(sorted(blocks), np.int64)
    if not blocks.size:
        return 0
    n = len(inp)
    rows = np.zeros((len(blocks), block_size), np.uint8)
    for r, i in enumerate(blocks):
        part = inp[i * block_size:min(n, (i + 1) * block_size)]
        rows[r, :len(part)] = part
    cand = lex_candidates(rows, wcap=int(matcher["wcap"]), depth=int(matcher["depth"]),
                          keys=int(matcher["keys"]))
    blk = at // block_size
    r = np.searchsorted(blocks, blk)
    sel = (r < len(blocks)) & (blocks[np.minimum(r, len(blocks) - 1)] == blk)
    p = at[sel] - blk[sel] * block_size
    rl = np.minimum(block_size, n - blk[sel] * block_size)
    want = np.minimum(np.minimum(cand[r[sel], p], rl - p), SEG - (p % SEG))
    return int(np.count_nonzero(ln[sel] < want))


def judge(data: bytes, stream: bytes, index, *, mode: str, block_size: int,
          matcher: dict | None = None, sample=()) -> dict:
    """Hold one encode's ``(stream, index)`` to ``data``. Returns the
    counts of :data:`COUNTS`: failed framing checks, blocks that do not
    decode on their own to their input, wrong or missing segment entries,
    input bytes a decoded token gets wrong, whether the standard library's
    decode of the whole stream disagrees (0 or 1), and, with a
    ``matcher``, the match tokens of the ``sample`` of blocks shorter than
    it finds (:func:`short_matches`)."""
    out = dict.fromkeys(COUNTS, 0)
    n, bs = len(data), block_size
    nblocks = max(1, -(-n // bs))
    inp = np.frombuffer(data, np.uint8)
    try:
        out["witness"] = int(zlib.decompress(stream, 31 if mode == "gzip" else 15) != data)
    except zlib.error:
        out["witness"] = 1
    try:
        hdr = _parse_header(stream, mode)
    except Malformed:
        out["framing"] += 1
        hdr = 10 if mode == "gzip" else 2
    tail = _trailer(data, mode)
    if stream[-len(tail):] != tail:
        out["framing"] += 1
    raw_l, offs, clen = (list(map(int, getattr(index, k))) for k in
                         ("raw_lengths", "compressed_offsets", "compressed_lengths"))
    want_raw = [min(bs, n - i * bs) for i in range(nblocks)] if n else [0]
    if not len(raw_l) == len(offs) == len(clen) == nblocks:
        out["framing"] += 1
        out["blocks"] = nblocks
        return out
    seg_all = getattr(index, "segment_bits", None)
    at = hdr
    for i in range(nblocks):
        out["framing"] += int(raw_l[i] != want_raw[i]) + int(offs[i] != at) + int(clen[i] <= 0)
        at = offs[i] + max(clen[i], 0)
    end = len(stream) - len(tail)
    if at > end or not _closing_ok(stream[at:end]):
        out["framing"] += 1
    lanes = _Lanes()
    bad_blocks = np.zeros(nblocks, np.int64)
    for i in range(nblocks):
        off, rl, gb = offs[i], want_raw[i], i * bs
        blob = stream[off:off + max(clen[i], 0)]
        want = data[gb:gb + rl]
        seg = None if seg_all is None else np.asarray(seg_all[i]).reshape(-1)
        if seg is not None and len(seg) != -(-bs // SEG):
            out["segments"] += -(-bs // SEG)
            seg = None
        elif seg is None:
            out["segments"] += -(-bs // SEG)
        try:
            bits = _Bits(blob)
            if bits.take(1):
                raise Malformed("a final block inside the stream")
            kind = bits.take(2)
            if kind == 0:
                if _stored_run(blob, bits, True) != want:
                    raise Malformed("stored bytes differ")
                if seg is not None:
                    out["segments"] += int(np.count_nonzero(seg != -1))
                continue
            if kind == 3:
                raise Malformed("reserved block type")
            lit, dist = (FIXED_LIT, FIXED_DIST) if kind == 1 else _read_dynamic(bits)
            if seg is None or rl == 0:
                d = zlib.decompressobj(-15)
                if d.decompress(blob) != want or d.eof or not blob.endswith(b"\0\0\xff\xff"):
                    raise Malformed("the block's bytes do not decode to its input")
                continue
            out["segments"] += lanes.add(i, blob, off, gb, rl, lit, dist, bits.bit, seg)
        except Malformed:
            bad_blocks[i] = 1
    if n:
        bad_lanes, wrong, bad_end = lanes.walk(stream, inp, nblocks)
    else:
        bad_lanes = wrong = bad_end = np.zeros(nblocks, np.int64)
    out["segments"] += int(bad_lanes.sum())
    out["wrong_bytes"] = int(wrong.sum())
    if matcher is not None and n:
        out["short_matches"] = short_matches(inp, *lanes.matches, sample,
                                             block_size=bs, matcher=matcher)
    bad_blocks |= (bad_lanes > 0) | (wrong > 0) | (bad_end > 0)
    out["blocks"] = int(bad_blocks.sum())
    return out
