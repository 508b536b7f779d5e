"""Brotli decoder (RFC 7932): the port's copy of
``compu_tpu/formats/brotli/decode.py``, all on the host.

It accepts any stream: every window code, metadata and uncompressed
meta-blocks, simple and complex prefix codes, block switching in the three
categories, context modes and maps with the inverse move-to-front, the
704-symbol insert-and-copy alphabet, postfix and direct distances with the
4-slot distance ring, and static dictionary references with the 121 word
transforms.
"""

from __future__ import annotations

import numpy as np

from ...ops.bitio import BitReader, NeedMoreBits
from ...ops.huffman import build_decode_table
from ..base import CodecFailure
from . import consts as C
from .transforms_data import TRANSFORMS

ERR_STREAM = 401
ERR_PREFIX = 402
ERR_CONTEXT = 403
ERR_DISTANCE = 404
ERR_DICT = 405
ERR_TRANSFORM = 406
ERR_BLOCK = 407
ERR_WINDOW = 408
ERR_PADDING = 409

ERRORS = {
    ERR_STREAM: "corrupt brotli stream",
    ERR_PREFIX: "invalid prefix code",
    ERR_CONTEXT: "invalid context map",
    ERR_DISTANCE: "distance out of range",
    ERR_DICT: "invalid dictionary reference",
    ERR_TRANSFORM: "invalid transform id",
    ERR_BLOCK: "invalid block header",
    ERR_WINDOW: "invalid window bits",
    ERR_PADDING: "non-zero padding",
}


class PrefixCode:
    """Decodable canonical prefix code (0-bit single-symbol supported)."""

    __slots__ = ("symbols", "lens", "max_bits", "single")

    def __init__(self, lengths: np.ndarray) -> None:
        nz = np.nonzero(lengths)[0]
        if len(nz) == 0:
            raise CodecFailure(ERR_PREFIX, ERRORS[ERR_PREFIX])
        if len(nz) == 1:
            self.single = int(nz[0])
            self.symbols = None
            self.lens = None
            self.max_bits = 0
            return
        self.single = None
        self.max_bits = int(np.max(lengths))
        self.symbols, self.lens = build_decode_table(lengths, self.max_bits)

    def decode(self, reader: BitReader) -> int:
        if self.single is not None:
            return self.single
        idx = reader.peek(self.max_bits)
        l = int(self.lens[idx])
        if l == 0:
            if reader.remaining_bits() < self.max_bits:
                raise NeedMoreBits()
            raise CodecFailure(ERR_PREFIX, ERRORS[ERR_PREFIX])
        if reader.remaining_bits() < l:
            raise NeedMoreBits()
        reader.skip(l)
        return int(self.symbols[idx])


def _read_count_code(reader: BitReader) -> int:
    """NBLTYPES / NTREES variable code: 1..256."""
    if reader.read(1) == 0:
        return 1
    k = reader.read(3)
    return (1 << k) + 1 + (reader.read(k) if k else 0)


def read_prefix_code(reader: BitReader, alphabet_size: int) -> PrefixCode:
    """§3.4/3.5: simple or complex prefix-code description."""
    hskip = reader.read(2)
    if hskip == 1:
        # Simple code: 1-4 explicit symbols.
        alpha_bits = max(1, (alphabet_size - 1).bit_length())
        nsym = reader.read(2) + 1
        syms = [reader.read(alpha_bits) for _ in range(nsym)]
        if any(s >= alphabet_size for s in syms) or len(set(syms)) != nsym:
            raise CodecFailure(ERR_PREFIX, ERRORS[ERR_PREFIX])
        lengths = np.zeros(alphabet_size, dtype=np.int64)
        if nsym == 1:
            lengths[syms[0]] = 1  # single-symbol degenerate code
            pc = PrefixCode.__new__(PrefixCode)
            pc.single = syms[0]
            pc.symbols = None
            pc.lens = None
            pc.max_bits = 0
            return pc
        if nsym == 2:
            lengths[syms] = 1
        elif nsym == 3:
            lengths[syms[0]] = 1
            lengths[syms[1]] = 2
            lengths[syms[2]] = 2
        else:
            if reader.read(1):
                lengths[syms[0]] = 1
                lengths[syms[1]] = 2
                lengths[syms[2]] = 3
                lengths[syms[3]] = 3
            else:
                lengths[syms] = 2
        return PrefixCode(lengths)

    # Complex code: code lengths for the code-length alphabet first.
    cl_lengths = np.zeros(18, dtype=np.int64)
    space = 32
    num_codes = 0
    for i in range(hskip, 18):
        idx4 = reader.peek(4)
        l = C.CLCODE_LUT_LEN[idx4]
        if reader.remaining_bits() < l:
            raise NeedMoreBits()
        reader.skip(l)
        v = C.CLCODE_LUT_VAL[idx4]
        cl_lengths[C.CLCODE_ORDER[i]] = v
        if v:
            num_codes += 1
            space -= 32 >> v
            if space <= 0:
                break
    if num_codes != 1 and space != 0:
        raise CodecFailure(ERR_PREFIX, "code-length code oversubscribed")
    cl_code = PrefixCode(cl_lengths)

    lengths = np.zeros(alphabet_size, dtype=np.int64)
    space = 32768
    prev_nonzero = 8
    i = 0
    rep_sym = 0
    rep_count = 0
    while i < alphabet_size and space > 0:
        sym = cl_code.decode(reader)
        if sym < 16:
            lengths[i] = sym
            i += 1
            if sym:
                prev_nonzero = sym
                space -= 32768 >> sym
            rep_sym = 0
            rep_count = 0
        else:
            extra_bits = 2 if sym == 16 else 3
            extra = reader.read(extra_bits)
            if rep_sym == sym:
                old = rep_count
                rep_count = ((rep_count - 2) << extra_bits) + 3 + extra
                reps = rep_count - old
            else:
                rep_sym = sym
                rep_count = 3 + extra
                reps = rep_count
            if i + reps > alphabet_size:
                raise CodecFailure(ERR_PREFIX, "repeat beyond alphabet")
            if sym == 16:
                lengths[i : i + reps] = prev_nonzero
                space -= (32768 >> prev_nonzero) * reps
            i += reps
    if space < 0:
        raise CodecFailure(ERR_PREFIX, "prefix code oversubscribed")
    if space > 0:
        nz = np.nonzero(lengths)[0]
        if len(nz) != 1:
            raise CodecFailure(ERR_PREFIX, "incomplete prefix code")
    return PrefixCode(lengths)


def _read_context_map(reader: BitReader, ntrees: int, size: int) -> np.ndarray:
    cmap = np.zeros(size, dtype=np.int64)
    if ntrees < 2:
        return cmap
    rlemax = 0
    if reader.read(1):
        rlemax = reader.read(4) + 1
    code = read_prefix_code(reader, ntrees + rlemax)
    i = 0
    while i < size:
        sym = code.decode(reader)
        if sym == 0:
            cmap[i] = 0
            i += 1
        elif sym <= rlemax:
            reps = (1 << sym) + reader.read(sym)
            if i + reps > size:
                raise CodecFailure(ERR_CONTEXT, ERRORS[ERR_CONTEXT])
            i += reps
        else:
            v = sym - rlemax
            if v >= ntrees:
                raise CodecFailure(ERR_CONTEXT, ERRORS[ERR_CONTEXT])
            cmap[i] = v
            i += 1
    if reader.read(1):  # inverse move-to-front
        mtf = list(range(256))
        for j in range(size):
            v = int(cmap[j])
            value = mtf[v]
            cmap[j] = value
            del mtf[v]
            mtf.insert(0, value)
    return cmap


class _BlockCategory:
    """Block-switching state for one category (literals / commands / dists)."""

    __slots__ = ("ntypes", "type_code", "count_code", "btype", "prev", "remaining")

    def __init__(self, reader: BitReader) -> None:
        self.ntypes = _read_count_code(reader)
        self.btype = 0
        self.prev = 1
        if self.ntypes >= 2:
            self.type_code = read_prefix_code(reader, self.ntypes + 2)
            self.count_code = read_prefix_code(reader, C.NUM_BLOCK_LEN_SYMBOLS)
            self.remaining = self._read_count(reader)
        else:
            self.type_code = None
            self.count_code = None
            self.remaining = 1 << 62

    def _read_count(self, reader: BitReader) -> int:
        sym = self.count_code.decode(reader)
        return C.BLOCK_COUNT_BASE[sym] + reader.read(C.BLOCK_COUNT_EXTRA[sym])

    def tick(self, reader: BitReader) -> None:
        if self.remaining == 0:
            sym = self.type_code.decode(reader)
            if sym == 0:
                new = self.prev
            elif sym == 1:
                new = (self.btype + 1) % self.ntypes
            else:
                new = sym - 2
            if new >= self.ntypes:
                raise CodecFailure(ERR_BLOCK, ERRORS[ERR_BLOCK])
            self.prev = self.btype
            self.btype = new
            self.remaining = self._read_count(reader)
        self.remaining -= 1


def _dictionary_word(copy_len: int, address: int) -> bytes:
    if not 4 <= copy_len <= 24:
        raise CodecFailure(ERR_DICT, ERRORS[ERR_DICT])
    ndbits = C.DICT_SIZE_BITS[copy_len]
    word_id = address & ((1 << ndbits) - 1)
    transform_id = address >> ndbits
    if transform_id >= len(TRANSFORMS):
        raise CodecFailure(ERR_TRANSFORM, ERRORS[ERR_TRANSFORM])
    offset = C.DICT_OFFSETS[copy_len] + word_id * copy_len
    word = C.DICTIONARY[offset : offset + copy_len]
    prefix, tname, k, suffix = TRANSFORMS[transform_id]
    if tname == "identity":
        mid = word
    elif tname == "omit_first":
        mid = word[k:]
    elif tname == "omit_last":
        mid = word[: len(word) - k]
    elif tname == "ferment_first":
        mid = _ferment(word, all_chars=False)
    else:  # ferment_all
        mid = _ferment(word, all_chars=True)
    return prefix + mid + suffix


def _ferment(word: bytes, all_chars: bool) -> bytes:
    """UTF-8 aware uppercasing per RFC 7932 §8 (transform types 10/11)."""
    out = bytearray(word)
    i = 0
    while i < len(out):
        c = out[i]
        if c < 192:
            if 97 <= c <= 122:
                out[i] ^= 32
            i += 1
        elif c < 224:
            if i + 1 < len(out):
                out[i + 1] ^= 32
            i += 2
        else:
            if i + 2 < len(out):
                out[i + 2] ^= 5
            i += 3
        if not all_chars:
            break
    return bytes(out)


class BrotliDecoderState:
    """Resumable whole-stream decoder: consumes complete meta-blocks,
    restarting an incomplete meta-block on the next pump."""

    def __init__(self) -> None:
        self.sink = bytearray()
        self.bitpos = 0
        self.window_bits = None
        self.window_size = None
        self.out_dropped = 0  # bytes trimmed off the front of self.out
        self.sink_budget = None  # pause once this many sink bytes pend
        self.done = False
        self.out = bytearray()  # full decoded output (window source)
        self.ring = list(C.INITIAL_DISTANCES)

    # ------------------------------------------------------------------
    def pump(self, staged, pos: int) -> tuple[int, bool]:
        del pos
        reader = BitReader(staged, self.bitpos)
        try:
            if self.window_bits is None:
                self._read_window_bits(reader)
                self.bitpos = reader.bitpos
            while not self.done:
                if (self.sink_budget is not None
                        and len(self.sink) >= self.sink_budget):
                    # Budget pause at a meta-block boundary (overshoot is
                    # bounded by one meta-block).
                    return self.bitpos // 8, False
                checkpoint = reader.bitpos
                ring_ckpt = list(self.ring)
                out_len_ckpt = len(self.out)
                try:
                    self._read_meta_block(reader)
                    self.bitpos = reader.bitpos
                    self.sink.extend(self.out[out_len_ckpt:])
                    # Bound the window copy: references reach at most
                    # window_size back, so the output prefix beyond it can
                    # be dropped (out_dropped keeps the logical length for
                    # max_distance / dictionary-word addressing).
                    if len(self.out) > self.window_size + (1 << 18):
                        drop = len(self.out) - self.window_size
                        self.out_dropped += drop
                        del self.out[:drop]
                except NeedMoreBits:
                    # Roll back the partial meta-block entirely.
                    self.ring = ring_ckpt
                    del self.out[out_len_ckpt:]
                    reader.bitpos = checkpoint
                    self.bitpos = checkpoint
                    raise
        except NeedMoreBits:
            return self.bitpos // 8, False
        return (self.bitpos + 7) // 8, True

    # ------------------------------------------------------------------
    def _read_window_bits(self, reader: BitReader) -> None:
        if reader.read(1) == 0:
            wbits = 16
        else:
            n = reader.read(3)
            if n != 0:
                wbits = 17 + n
            else:
                m = reader.read(3)
                if m == 0:
                    wbits = 17
                elif m == 1:
                    raise CodecFailure(ERR_WINDOW, ERRORS[ERR_WINDOW])
                else:
                    wbits = 8 + m
        self.window_bits = wbits
        self.window_size = (1 << wbits) - 16

    # ------------------------------------------------------------------
    def _read_meta_block(self, reader: BitReader) -> None:
        islast = reader.read(1)
        if islast and reader.read(1):  # ISLASTEMPTY
            self.done = True
            return
        mnibbles = reader.read(2)
        if mnibbles == 3:
            # Metadata block: byte-aligned skip.
            if reader.read(1):
                raise CodecFailure(ERR_BLOCK, "reserved metadata bit")
            mskipbytes = reader.read(2)
            skip = 0
            for k in range(mskipbytes):
                skip |= reader.read(8) << (8 * k)
            if mskipbytes and skip == 0:
                raise CodecFailure(ERR_BLOCK, ERRORS[ERR_BLOCK])
            if mskipbytes:
                skip += 1
            reader.align_byte()
            if reader.remaining_bits() < 8 * skip:
                raise NeedMoreBits()
            reader.skip(8 * skip)
            if islast:
                self.done = True
            return
        mlen = 0
        for k in range(mnibbles + 4):
            mlen |= reader.read(4) << (4 * k)
        mlen += 1
        if not islast and reader.read(1):  # ISUNCOMPRESSED
            reader.align_byte()
            if reader.remaining_bits() < 8 * mlen:
                raise NeedMoreBits()
            start = reader.bitpos // 8
            self.out.extend(reader.data[start : start + mlen])
            reader.skip(8 * mlen)
            return
        self._read_compressed_meta_block(reader, mlen, islast)
        if islast:
            self.done = True

    # ------------------------------------------------------------------
    def _read_compressed_meta_block(self, reader: BitReader, mlen: int, islast: int) -> None:
        lit_blocks = _BlockCategory(reader)
        cmd_blocks = _BlockCategory(reader)
        dist_blocks = _BlockCategory(reader)

        npostfix = reader.read(2)
        ndirect = reader.read(4) << npostfix
        cmodes = [reader.read(2) for _ in range(lit_blocks.ntypes)]

        ntrees_l = _read_count_code(reader)
        cmap_l = _read_context_map(reader, ntrees_l, 64 * lit_blocks.ntypes)
        ntrees_d = _read_count_code(reader)
        cmap_d = _read_context_map(reader, ntrees_d, 4 * dist_blocks.ntypes)

        lit_codes = [read_prefix_code(reader, C.NUM_LITERAL_SYMBOLS) for _ in range(ntrees_l)]
        cmd_codes = [read_prefix_code(reader, C.NUM_COMMAND_SYMBOLS) for _ in range(cmd_blocks.ntypes)]
        dist_alphabet = 16 + ndirect + (48 << npostfix)
        dist_codes = [read_prefix_code(reader, dist_alphabet) for _ in range(ntrees_d)]

        out = self.out
        ring = self.ring
        ctx_table = C.CONTEXT_TABLE
        postfix_mask = (1 << npostfix) - 1
        to_decode = mlen
        while to_decode > 0:
            cmd_blocks.tick(reader)
            cmd_sym = cmd_codes[cmd_blocks.btype].decode(reader)
            range_idx = cmd_sym >> 6
            implicit = False
            if range_idx < 2:
                implicit = True
            else:
                range_idx -= 2
            insert_code = C.INSERT_RANGE_LUT[range_idx] + ((cmd_sym >> 3) & 7)
            copy_code = C.COPY_RANGE_LUT[range_idx] + (cmd_sym & 7)
            insert_len = C.INSERT_BASE[insert_code] + reader.read(C.INSERT_EXTRA[insert_code])
            copy_len = C.COPY_BASE[copy_code] + reader.read(C.COPY_EXTRA[copy_code])

            # Literals.
            for _ in range(insert_len):
                lit_blocks.tick(reader)
                bt = lit_blocks.btype
                mode = cmodes[bt]
                p1 = out[-1] if out else 0
                p2 = out[-2] if len(out) > 1 else 0
                cid = int(ctx_table[(mode << 9) + p1]) | int(
                    ctx_table[(mode << 9) + 256 + p2]
                )
                tree = lit_codes[int(cmap_l[(bt << 6) + cid])]
                out.append(tree.decode(reader))
            to_decode -= insert_len
            if to_decode <= 0:
                if to_decode < 0:
                    raise CodecFailure(ERR_STREAM, "insert overruns meta-block")
                break

            # Distance.
            dsym = 0
            if implicit:
                distance = ring[0]
            else:
                dist_blocks.tick(reader)
                cid = 3 if copy_len > 4 else copy_len - 2
                tree = dist_codes[int(cmap_d[(dist_blocks.btype << 2) + cid])]
                dsym = tree.decode(reader)
                distance = self._resolve_distance(
                    dsym, reader, ndirect, npostfix, postfix_mask
                )
                if distance <= 0:
                    raise CodecFailure(ERR_DISTANCE, ERRORS[ERR_DISTANCE])

            max_distance = min(len(out) + self.out_dropped, self.window_size)
            # Ring buffer: updated for real backward copies with a nonzero
            # distance code; never for code 0 or dictionary references.
            if not implicit and dsym != 0 and distance <= max_distance:
                ring[1:] = ring[:3]
                ring[0] = distance
            if distance <= max_distance:
                start = len(out) - distance
                if distance >= copy_len:
                    out.extend(out[start : start + copy_len])
                else:
                    for _ in range(copy_len):
                        out.append(out[start])
                        start += 1
                to_decode -= copy_len
            else:
                # Static dictionary reference.
                address = distance - max_distance - 1
                word = _dictionary_word(copy_len, address)
                if len(word) > to_decode:
                    raise CodecFailure(ERR_DICT, "dictionary word overruns block")
                out.extend(word)
                to_decode -= len(word)
        del islast

    def _resolve_distance(self, dsym, reader, ndirect, npostfix, postfix_mask) -> int:
        ring = self.ring
        if dsym < 16:
            if dsym < 4:
                return ring[dsym]
            # Symbols 4..15: ring[0]/ring[1] +/- 1..3
            base = ring[0] if dsym < 10 else ring[1]
            k = dsym - 4 if dsym < 10 else dsym - 10
            delta = (k >> 1) + 1
            if k & 1:
                return base + delta
            return base - delta
        if dsym < 16 + ndirect:
            return dsym - 16 + 1
        dcode = dsym - ndirect - 16
        nbits = 1 + (dcode >> (npostfix + 1))
        hcode = dcode >> npostfix
        lcode = dcode & postfix_mask
        offset = ((2 + (hcode & 1)) << nbits) - 4
        extra = reader.read(nbits)
        return ((offset + extra) << npostfix) + lcode + ndirect + 1
