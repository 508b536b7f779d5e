"""Brotli encoder (RFC 7932): the port's copy of
``compu_tpu/formats/brotli/encode.py``.

Each meta-block of up to 1 MiB takes its LZ tokens from one
``DeviceTokenizer`` call (kernels B1 and B2 on the device; the default),
or on the host route from the host match finder and parse
(``deflate_encode.tokenize`` at the quality's level, with deeper chain
walks and a hash-6 tier at quality 10 and 11), and is written on the
host: adjacent same-distance matches merged into long copies, one block
type per category, the UTF8 literal context model from quality 5 (Text:
quality 2), explicit distances (NPOSTFIX=0, NDIRECT=0) beside the ring's
short codes, and optimal prefix codes per meta-block in simple or complex
form. A final empty meta-block ends the stream, so data meta-blocks never
carry ISLAST.

The command building, the distance plan and the body emission run in the
host runtime (``native_enc.py``) for a meta-block of more than 256
tokens, as the reference's do; their pure-Python loops
(``_commands_from_tokens_py``, ``_distance_plan_py``, ``_emit_body_py``)
are the twins, and write the same bits.
"""

from __future__ import annotations

import numpy as np

from ...ops.huffman import canonical_codes, length_limited_lengths
from ..base import CodecFailure
from ..deflate.deflate_encode import tokenize
from ..deflate.options import ZlibStrategy
from ..device_lz import DeviceTokenizer
from . import native_enc
from . import consts as C

ERR_ENC = 450
#: Bytes a tokenizer call covers: one meta-block of the pipeline.
TOKENIZER_SPAN = 1 << 20


class BitSink:
    """LSB-first bit accumulator with whole-byte drain (cross-chunk carry)."""

    __slots__ = ("acc", "nbits", "out")

    def __init__(self) -> None:
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def push(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc |= (value & ((1 << n) - 1)) << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def align(self) -> None:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.nbits = 0

    def drain(self) -> bytes:
        data = bytes(self.out)
        self.out = bytearray()
        return data


# -- prefix-code serialization ---------------------------------------------
_CL_WRITE = {0: (0, 2), 4: (1, 2), 3: (2, 2), 2: (3, 3), 1: (7, 4), 5: (15, 4)}


class PrefixWriter:
    """One canonical prefix code + its §3.4/§3.5 serialized description."""

    def __init__(self, freqs: np.ndarray, alphabet_size: int) -> None:
        freqs = np.asarray(freqs, dtype=np.int64)
        used = np.nonzero(freqs)[0]
        if len(used) == 0:
            used = np.asarray([0])
            freqs = freqs.copy()
            freqs[0] = 1
        self.alphabet_size = alphabet_size
        self.used = used
        if len(used) == 1:
            self.lengths = np.zeros(alphabet_size, dtype=np.int64)
            self.codes = np.zeros(alphabet_size, dtype=np.int64)
            self.single = int(used[0])
            return
        self.single = None
        self.lengths = length_limited_lengths(freqs, 15).astype(np.int64)
        codes = canonical_codes(self.lengths)
        # Reverse within length for LSB-first emission.
        self.codes = np.zeros(alphabet_size, dtype=np.int64)
        for s in np.nonzero(self.lengths)[0]:
            l = int(self.lengths[s])
            c = int(codes[s])
            rev = 0
            for _ in range(l):
                rev = (rev << 1) | (c & 1)
                c >>= 1
            self.codes[s] = rev

    def write_description(self, sink: BitSink) -> None:
        used = self.used
        alpha_bits = max(1, (self.alphabet_size - 1).bit_length())
        if self.single is not None:
            sink.push(1, 2)  # HSKIP=1: simple
            sink.push(0, 2)  # NSYM-1 = 0
            sink.push(self.single, alpha_bits)
            return
        if len(used) <= 4:
            lens_used = self.lengths[used]
            simple_ok = False
            order = list(used)
            if len(used) == 2 and set(lens_used) == {1}:
                simple_ok = True
            elif len(used) == 3 and sorted(lens_used) == [1, 2, 2]:
                simple_ok = True
                order = sorted(used, key=lambda s: (self.lengths[s], s))
            elif len(used) == 4 and sorted(lens_used) in ([2, 2, 2, 2], [1, 2, 3, 3]):
                simple_ok = True
                order = sorted(used, key=lambda s: (self.lengths[s], s))
            if simple_ok:
                sink.push(1, 2)
                sink.push(len(used) - 1, 2)
                for s in order:
                    sink.push(int(s), alpha_bits)
                if len(used) == 4:
                    sink.push(0 if sorted(lens_used) == [2, 2, 2, 2] else 1, 1)
                return
        self._write_complex(sink)

    def _write_complex(self, sink: BitSink) -> None:
        # RLE the symbol code-length sequence with brotli's 16/17 codes
        # (no chained-repeat accumulation; plain runs are always valid).
        lengths = self.lengths
        top = int(np.nonzero(lengths)[0][-1]) + 1
        items: list[tuple[int, int, int]] = []  # (clsym, extra_val, extra_bits)

        def emit_repeat(sym: int, extra_bits: int, count: int, literal):
            """Chained repeat encoding: consecutive equal repeat symbols
            accumulate in the decoder as new = (old-2)*2^bits + 3 + extra,
            so the count is emitted as base-2^bits digits, most significant
            first (libbrotli's WriteHuffmanTreeRepetitions construction)."""
            if count < 3:
                items.extend([literal] * count)
                return
            r = count - 3
            digits = []
            mask = (1 << extra_bits) - 1
            while True:
                digits.append(r & mask)
                r >>= extra_bits
                if r == 0:
                    break
                r -= 1
            for d in reversed(digits):
                items.append((sym, d, extra_bits))

        prev_nonzero = 8
        i = 0
        while i < top:
            v = int(lengths[i])
            run = 1
            while i + run < top and int(lengths[i + run]) == v:
                run += 1
            consumed = run
            if v == 0:
                emit_repeat(17, 3, run, (0, 0, 0))
            else:
                if v != prev_nonzero:
                    items.append((v, 0, 0))
                    run -= 1
                emit_repeat(16, 2, run, (v, 0, 0))
                prev_nonzero = v
            i += consumed
        # Code-length-code lengths: fixed mapping via _CL_WRITE (values 0-5).
        cl_freq = np.zeros(18, dtype=np.int64)
        for sym, _, _ in items:
            cl_freq[sym] += 1
        cl_lengths = length_limited_lengths(cl_freq, 5).astype(np.int64)
        nz = np.nonzero(cl_lengths)[0]
        if len(nz) == 1:
            # Degenerate: a single code-length symbol decodes with 0 bits;
            # ensure the per-symbol loop terminates via space accounting.
            cl_lengths = cl_lengths.copy()
        cl_codes = canonical_codes(cl_lengths)
        cl_rev = np.zeros(18, dtype=np.int64)
        for s in nz:
            l = int(cl_lengths[s])
            c = int(cl_codes[s])
            rev = 0
            for _ in range(l):
                rev = (rev << 1) | (c & 1)
                c >>= 1
            cl_rev[s] = rev
        sink.push(0, 2)  # HSKIP = 0
        # Emit code-length-code lengths exactly as far as the decoder reads:
        # it stops once the code completes (space accounting reaches zero).
        space = 32
        for idx in range(18):
            value = int(cl_lengths[C.CLCODE_ORDER[idx]])
            code, nbits = _CL_WRITE[value]
            sink.push(code, nbits)
            if value:
                space -= 32 >> value
                if space <= 0:
                    break
        for sym, extra_val, extra_bits in items:
            if len(nz) > 1:
                sink.push(int(cl_rev[sym]), int(cl_lengths[sym]))
            # single-code-length alphabet: 0 bits per symbol
            if extra_bits:
                sink.push(extra_val, extra_bits)

    def push_symbol(self, sink: BitSink, sym: int) -> None:
        if self.single is not None:
            return  # 0-bit code
        sink.push(int(self.codes[sym]), int(self.lengths[sym]))


# -- command construction ---------------------------------------------------
# (insert_hi, copy_hi) pairs per range index (units of 8 codes).
_RANGE_PAIRS = {(C.INSERT_RANGE_LUT[i] >> 3, C.COPY_RANGE_LUT[i] >> 3): i
                for i in range(9)}
# Dense (-1 = invalid) LUT over (insert_code >> 3, copy_code >> 3).
_RANGE_LUT = np.full((4, 4), -1, dtype=np.int64)
for _pair, _i in _RANGE_PAIRS.items():
    _RANGE_LUT[_pair] = _i


def _length_codes_vec(bases, extras, values):
    """Each value's length code: the index of the last base at or below
    it, bumped past bases whose extra bits cannot reach it (one
    searchsorted for the whole command list)."""
    bases = np.asarray(bases, dtype=np.int64)
    extras = np.asarray(extras, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    idx = np.searchsorted(bases, values, side="right") - 1
    for _ in range(4):  # corrective bumps for non-contiguous code ranges
        can = idx + 1 < len(bases)
        bump = can & (bases[idx] + (np.int64(1) << extras[idx]) <= values)
        if not bump.any():
            break
        idx = idx + bump
    return idx


def _plan_distances(commands, ic_arr, cc_arr, ring):
    """Choose each copy's distance coding with the 4-slot ring tracked
    exactly as the decoder resolves it (decode.py::_resolve_distance):

    * ``("imp",)`` — implicit ring[0] via a command symbol < 128 (free);
    * ``(dsym, 0, 0)`` for short codes 0-15 (ring slots and ring[0/1]±1..3);
    * ``(dsym, extra, nbits)`` explicit otherwise.

    Ring updates mirror the decoder: explicit and short codes 1-15 push the
    distance; code 0 and implicit copies do not. ``ic_arr``/``cc_arr`` are
    the precomputed per-command insert/copy length codes.

    ``ring`` is the incoming 4-slot state and the FINAL state is returned
    with the plan: the decoder's ring persists across meta-blocks
    (decode.py carries it through the whole stream), so the encoder must
    thread it through chunks too — a per-meta-block reset desynchronizes
    every ring-coded distance in chunk 2+ until four explicit distances
    refill the ring (found as corpus-dependent corruption on multi-chunk
    streams)."""
    ring = list(ring)
    plan = []
    for (_, ins, cl, d), ic, cc in zip(commands, ic_arr, cc_arr):
        if d is None:
            plan.append(None)
            continue
        if d == ring[0] and ic < 8 and cc < 16:
            plan.append(("imp",))
            continue
        sc = None
        for s in range(4):
            if d == ring[s]:
                sc = s
                break
        if sc is None:
            for dsym in range(4, 16):
                base = ring[0] if dsym < 10 else ring[1]
                k = dsym - 4 if dsym < 10 else dsym - 10
                delta = (k >> 1) + 1
                cand = base + delta if (k & 1) else base - delta
                if cand == d and cand > 0:
                    sc = dsym
                    break
        if sc is not None:
            plan.append((sc, 0, 0))
            if sc != 0:
                ring = [d] + ring[:3]
        else:
            dsym, extra, nbits = _distance_symbol(d)
            plan.append((dsym, extra, nbits))
            ring = [d] + ring[:3]
    return plan, ring


def _distance_symbol(distance: int):
    """Explicit distance (NPOSTFIX=0, NDIRECT=0): dsym, extra value/bits."""
    val = distance - 1
    nbits = 1
    while True:
        lo = (2 << nbits) - 4
        hi = (3 << nbits) - 4
        nxt = (4 << nbits) - 4
        if lo <= val < hi:
            return 16 + (nbits - 1) * 2, val - lo, nbits
        if hi <= val < nxt:
            return 16 + (nbits - 1) * 2 + 1, val - hi, nbits
        nbits += 1
        if nbits > 24:
            raise CodecFailure(ERR_ENC, "distance too large")


def _push_count_code(sink: BitSink, v: int) -> None:
    """NBLTYPES/NTREES variable code (inverse of decode._read_count_code)."""
    if v == 1:
        sink.push(0, 1)
        return
    k = (v - 1).bit_length() - 1
    sink.push(1, 1)
    sink.push(k, 3)
    if k:
        sink.push(v - 1 - (1 << k), k)


def _push_context_map(sink: BitSink, cmap: np.ndarray, ntrees: int) -> None:
    """Context map: no RLE, direct tree indices, no inverse-MTF."""
    sink.push(0, 1)  # RLE unused
    freqs = np.bincount(cmap, minlength=ntrees)
    code = PrefixWriter(freqs, ntrees)
    code.write_description(sink)
    for v in cmap:
        code.push_symbol(sink, int(v))
    sink.push(0, 1)  # IMTF = 0


def _context_model(arr: np.ndarray, lit_pos: np.ndarray, lit_vals: np.ndarray,
                   enabled: bool, tail: bytes = b"", max_trees: int = 16):
    """Cluster the 64 UTF8-mode literal contexts into <= max_trees trees.

    ``tail`` holds the last bytes of the previous meta-block: the decoder's
    context bytes p1/p2 carry across meta-block boundaries.
    Returns (cmap[64], [PrefixWriter...], cid_of_pos). Falls back to a
    single unmodeled tree for small or non-gaining inputs.
    """
    lit_freq = np.bincount(lit_vals, minlength=256) if len(lit_vals) else np.zeros(256, np.int64)
    single = (np.zeros(64, np.int64), [PrefixWriter(lit_freq, 256)], lambda k: 0)
    if not enabled or len(lit_pos) < 2048:
        return single
    lut0 = C.CONTEXT_TABLE[1024:1280].astype(np.int64)
    lut1 = C.CONTEXT_TABLE[1280:1536].astype(np.int64)
    t = np.frombuffer((b"\0\0" + tail)[-2:], dtype=np.uint8).astype(np.int64)
    ext = np.concatenate([t, arr.astype(np.int64)])
    p1 = ext[lit_pos + 1]
    p2 = ext[lit_pos]
    cids = lut0[p1] | lut1[p2]
    hists = np.zeros((64, 256), dtype=np.int64)
    np.add.at(hists, (cids, lit_vals.astype(np.int64)), 1)

    # Greedy histogram clustering (brotli HistogramCombine shape): merge
    # the pair whose combined entropy cost increases least, while the
    # increase stays below the saving of one fewer tree description.
    # Pairwise merge costs are kept as a matrix and only the merged
    # cluster's row is recomputed per step (the rescan-everything loop was
    # ~100K per-pair entropy calls, ~0.5 s per meta-block).
    def _ent_rows(mat):
        tot = mat.sum(axis=-1)
        lg = np.where(mat > 0, np.log2(np.maximum(mat, 1)), 0.0)
        return (np.where(tot > 0, tot * np.log2(np.maximum(tot, 1)), 0.0)
                - (mat * lg).sum(axis=-1))

    hs = hists.astype(np.float64)
    costs_v = _ent_rows(hs)
    # delta[i, j] = ent(h_i + h_j) - ent(h_i) - ent(h_j), inf on/below diag
    pair = hs[:, None, :] + hs[None, :, :]
    delta_m = _ent_rows(pair) - costs_v[:, None] - costs_v[None, :]
    delta_m[~np.triu(np.ones((64, 64), dtype=bool), k=1)] = np.inf
    members = [[c] for c in range(64)]
    alive = np.ones(64, dtype=bool)
    TREE_DESC_BITS = 70 * 8  # rough per-tree description cost
    nalive = 64
    while nalive > 1:
        flat = np.argmin(delta_m)
        i, j = int(flat // 64), int(flat % 64)
        delta = delta_m[i, j]
        if nalive <= max_trees and delta > TREE_DESC_BITS:
            break
        hs[i] += hs[j]
        members[i] += members[j]
        costs_v[i] = _ent_rows(hs[i][None, :])[0]
        alive[j] = False
        nalive -= 1
        delta_m[j, :] = np.inf
        delta_m[:, j] = np.inf
        others = np.nonzero(alive)[0]
        others = others[others != i]
        if len(others):
            merged = _ent_rows(hs[i][None, :] + hs[others])
            d_new = merged - costs_v[i] - costs_v[others]
            lo = np.minimum(others, i)
            hi = np.maximum(others, i)
            delta_m[lo, hi] = d_new
    clusters = [hs[c].astype(np.int64) for c in np.nonzero(alive)[0]]
    members = [members[c] for c in np.nonzero(alive)[0]]
    ntrees = len(clusters)
    if ntrees < 2:
        return single
    cmap = np.zeros(64, dtype=np.int64)
    for t, mem in enumerate(members):
        for c in mem:
            cmap[c] = t
    codes = [PrefixWriter(h, 256) for h in clusters]

    def cid_of_pos(k: int) -> int:
        return int(lut0[ext[k + 1]] | lut1[ext[k]])

    return cmap, codes, cid_of_pos


# -- the meta-block's stages ------------------------------------------------
#: The largest copy length a command codes (copy code base 2118 + 24 extra bits).
MAX_COPY = C.COPY_BASE[-1] + (1 << C.COPY_EXTRA[-1]) - 1
#: A meta-block of more tokens than this runs its stages in the host runtime.
NATIVE_MIN_TOKENS = 256


def _commands_from_tokens(tok_pos, tok_len, tok_dist):
    """The meta-block's commands as parallel (start, ins, cl, dist) arrays
    (dist -1 for a trailing literal-only command). Adjacent same-distance
    matches merge into one long copy (brotli's copy lengths reach far past
    the matcher's 258), up to ``MAX_COPY``. The host runtime's loop above
    ``NATIVE_MIN_TOKENS`` tokens, else ``_commands_from_tokens_py``."""
    if len(tok_pos) > NATIVE_MIN_TOKENS:
        return native_enc.commands_from_tokens(tok_pos, tok_len, tok_dist, MAX_COPY)
    return _commands_from_tokens_py(tok_pos, tok_len, tok_dist)


def _commands_from_tokens_py(tok_pos, tok_len, tok_dist):
    """The Python twin of ``_commands_from_tokens``."""
    commands = []
    pending_start = 0
    pending = 0
    for p, l, d in zip(tok_pos, tok_len, tok_dist):
        if l == 0:
            if pending == 0:
                pending_start = p
            pending += 1
        else:
            if (
                commands
                and pending == 0
                and commands[-1][3] == int(d)
                and commands[-1][2] + int(l) <= MAX_COPY
            ):
                prev = commands[-1]
                commands[-1] = (prev[0], prev[1], prev[2] + int(l), prev[3])
            else:
                commands.append((pending_start, pending, int(l), int(d)))
                pending = 0
            pending_start = p + l
    if pending:
        commands.append((pending_start, pending, 0, -1))
    ca = (np.asarray(commands, dtype=np.int64)
          if commands else np.zeros((0, 4), np.int64))
    return ca[:, 0], ca[:, 1], ca[:, 2], ca[:, 3]


def _distance_plan_py(start_a, ins_a, cl_a, dist_a, ic_arr, cc_arr, ring):
    """The Python twin of ``native_enc.plan_distances``: ``_plan_distances``
    as (dsym, dextra, dbits, ring) arrays."""
    commands_t = [(int(s), int(i_), int(c), None if d < 0 else int(d))
                  for s, i_, c, d in zip(start_a, ins_a, cl_a, dist_a)]
    dist_plan, ring = _plan_distances(commands_t, ic_arr, cc_arr, ring)
    dsym_a = np.asarray(
        [-2 if p is None else (-1 if p[0] == "imp" else p[0])
         for p in dist_plan], dtype=np.int64)
    dextra_a = np.asarray(
        [0 if p is None or p[0] == "imp" else p[1]
         for p in dist_plan], dtype=np.int64)
    dbits_a = np.asarray(
        [0 if p is None or p[0] == "imp" else p[2]
         for p in dist_plan], dtype=np.int64)
    return dsym_a, dextra_a, dbits_a, ring


def _plan_commands(start_a, ins_a, cl_a, dist_a, ring, use_native: bool):
    """The commands' insert and copy length codes, each copy's distance
    coding (the host runtime's ``plan_distances`` when ``use_native``,
    else ``_distance_plan_py``), the command symbols and the command and
    distance histograms. Returns ``(ic, cc, cmd, dsym, dextra, dbits,
    cmd_freq, dist_freq, ring)``: ``dsym`` is -2 for no distance, -1 for
    the implicit ring[0]; ``ring`` is the ring after the meta-block."""
    cl_eff = np.where(dist_a >= 0, cl_a, 2)
    ic_arr = _length_codes_vec(C.INSERT_BASE, C.INSERT_EXTRA, ins_a)
    cc_arr = _length_codes_vec(C.COPY_BASE, C.COPY_EXTRA, cl_eff)
    if use_native:
        dsym_a, dextra_a, dbits_a, ring = native_enc.plan_distances(ic_arr, cc_arr, dist_a, ring)
    else:
        dsym_a, dextra_a, dbits_a, ring = _distance_plan_py(
            start_a, ins_a, cl_a, dist_a, ic_arr, cc_arr, ring)
    imp_arr = dsym_a == -1
    pair_idx = _RANGE_LUT[ic_arr >> 3, cc_arr >> 3]
    if np.any((pair_idx < 0) & ~imp_arr):
        raise CodecFailure(ERR_ENC, "unencodable insert/copy pair")
    low6 = ((ic_arr & 7) << 3) | (cc_arr & 7)
    cmd_arr = np.where(
        imp_arr, ((cc_arr >> 3) << 6) | low6,
        ((pair_idx + 2) << 6) | low6,
    ).astype(np.int64)
    dist_syms = dsym_a[dsym_a >= 0]
    cmd_freq = np.bincount(cmd_arr, minlength=C.NUM_COMMAND_SYMBOLS)
    dist_freq = np.bincount(
        dist_syms if len(dist_syms) else np.zeros(1, np.int64), minlength=64
    )
    return ic_arr, cc_arr, cmd_arr, dsym_a, dextra_a, dbits_a, cmd_freq, dist_freq, ring


def _write_meta_block_header(sink: BitSink, mlen: int, cmap, lit_codes, cmd_freq, dist_freq):
    """The compressed meta-block's header and its prefix codes'
    descriptions. Returns the command and distance codes."""
    ntrees_l = len(lit_codes)
    cmd_code = PrefixWriter(cmd_freq, C.NUM_COMMAND_SYMBOLS)
    dist_code = PrefixWriter(dist_freq, 64)
    sink.push(0, 1)  # ISLAST = 0 (final empty block terminates)
    if mlen <= 1 << 16:
        sink.push(0, 2)  # MNIBBLES = 4
        sink.push(mlen - 1, 16)
    elif mlen <= 1 << 20:
        sink.push(1, 2)  # MNIBBLES = 5
        sink.push(mlen - 1, 20)
    else:
        sink.push(2, 2)  # MNIBBLES = 6
        sink.push(mlen - 1, 24)
    sink.push(0, 1)  # ISUNCOMPRESSED = 0
    sink.push(0, 1)  # NBLTYPESL = 1
    sink.push(0, 1)  # NBLTYPESI = 1
    sink.push(0, 1)  # NBLTYPESD = 1
    sink.push(0, 2)  # NPOSTFIX = 0
    sink.push(0, 4)  # NDIRECT = 0
    sink.push(2 if ntrees_l > 1 else 0, 2)  # CMODE: UTF8 when modeled
    _push_count_code(sink, ntrees_l)  # NTREESL
    if ntrees_l > 1:
        _push_context_map(sink, cmap, ntrees_l)
    sink.push(0, 1)  # NTREESD = 1
    for code in lit_codes:
        code.write_description(sink)
    cmd_code.write_description(sink)
    dist_code.write_description(sink)
    return cmd_code, dist_code


def _emit_body(sink: BitSink, data: bytes, tail2: bytes, commands, plan, cmd_code, dist_code,
               lit_codes, cmap, cid_of_pos, use_native: bool) -> None:
    """The meta-block's commands into ``sink``: the host runtime's loop
    when ``use_native`` (``tail2``, the two bytes before ``data``, give the
    first literals' contexts), else ``_emit_body_py``."""
    if not use_native:
        _emit_body_py(sink, data, commands, plan, cmd_code, dist_code, lit_codes, cmap,
                      cid_of_pos)
        return
    blob, sink.acc, sink.nbits = native_enc.emit_commands(
        data, tail2, *commands, *plan, cmd_code, dist_code, lit_codes, cmap,
        sink.acc, sink.nbits)
    sink.out.extend(blob)


def _emit_body_py(sink: BitSink, data: bytes, commands, plan, cmd_code, dist_code, lit_codes,
                  cmap, cid_of_pos) -> None:
    """The Python twin of the body's emission, one symbol at a time: each
    command's symbol and length extras, its literals (each through the
    tree of its context when the literals are modelled), and its distance
    symbol and extra bits unless the command implies ring[0]."""
    start_a, ins_a, cl_a, dist_a = commands
    ic_arr, cc_arr, cmd_arr, dsym_a, dextra_a, dbits_a = plan
    for ci in range(len(start_a)):
        start, ins = int(start_a[ci]), int(ins_a[ci])
        cl, d = int(cl_a[ci]), int(dist_a[ci])
        cmd, ic, cc = int(cmd_arr[ci]), int(ic_arr[ci]), int(cc_arr[ci])
        cmd_code.push_symbol(sink, cmd)
        sink.push(ins - C.INSERT_BASE[ic], C.INSERT_EXTRA[ic])
        sink.push((cl if d >= 0 else 2) - C.COPY_BASE[cc], C.COPY_EXTRA[cc])
        if len(lit_codes) > 1:
            for k in range(start, start + ins):
                tree = int(cmap[cid_of_pos(k)])
                lit_codes[tree].push_symbol(sink, data[k])
        else:
            for b in data[start : start + ins]:
                lit_codes[0].push_symbol(sink, b)
        if d >= 0 and int(dsym_a[ci]) != -1:
            dist_code.push_symbol(sink, int(dsym_a[ci]))
            sink.push(int(dextra_a[ci]), int(dbits_a[ci]))


class BrotliStreamEncoder:
    """Meta-block streaming encoder with cross-chunk bit carry. With
    ``device_lz`` its LZ stage runs on ``device`` (CUDA by default;
    ``"cpu"`` runs the kernels' plain versions); without, on the host,
    and no tokenizer is made.

    The tokenizer is made with the stream's header, for the window the
    header writes: a one-shot input of at most 64 KiB is written with
    WBITS=16, so its matches reach at most 65,520 back, as the host
    route's do. (The reference builds its tokenizer once for the
    configured window, so such a stream may hold a distance its window
    does not allow, and it keeps the cut window after ``reset``.)"""

    def __init__(self, quality: int = 9, window_bits: int = 22, mode=None,
                 device=None, device_lz: bool = True) -> None:
        self.quality = quality
        self.window_bits = window_bits
        self.device = device
        self.device_lz = device_lz
        # The input-type hint drives the literal context model: Text
        # enables the UTF8 context map from quality 2, Font disables it,
        # Generic enables it from quality 5.
        self.mode_name = getattr(mode, "name", None) or "Generic"
        self.reset()

    def reset(self) -> None:
        self.sink = BitSink()
        self.wbits = None  # the stream's window, set by its header
        self.tokenizer = None
        self._tail = b""
        self._ring = list(C.INITIAL_DISTANCES)

    def _write_stream_header(self, w: int) -> None:
        if w == 16:
            self.sink.push(0, 1)
        elif 18 <= w <= 24:
            self.sink.push(1, 1)
            self.sink.push(w - 17, 3)
        elif w == 17:
            self.sink.push(1, 1)
            self.sink.push(0, 3)
            self.sink.push(0, 3)
        else:  # 10..15
            self.sink.push(1, 1)
            self.sink.push(0, 3)
            self.sink.push(w - 8, 3)
        self.wbits = w
        if self.device_lz:
            self.tokenizer = DeviceTokenizer(TOKENIZER_SPAN, min((1 << w) - 16, TOKENIZER_SPAN),
                                             device=self.device)

    def compress_chunk(self, data: bytes, final: bool) -> bytes:
        if self.wbits is None:
            # A one-shot input of at most 64 KiB takes WBITS=16, the
            # shortest window code (a single 0 bit); its tokenizer is made
            # for that window, 65,520 bytes.
            w = self.window_bits
            if final and len(data) <= (1 << 16) and w > 16:
                w = 16
            self._write_stream_header(w)
        if data:
            self._write_data_meta_block(data)
        if final:
            # Final empty meta-block: ISLAST=1, ISLASTEMPTY=1, pad to byte.
            self.sink.push(1, 1)
            self.sink.push(1, 1)
            self.sink.align()
        return self.sink.drain()

    def _host_tokens(self, arr: np.ndarray):
        """The host route's token cover of one meta-block. Quality 10/11
        buy ratio with deep chain walks (the libbrotli q10/q11 role): a
        moderate hash-3 walk for near matches and a hash-6 tier whose
        chains hold only long-match candidates; the level-9 cost-model DP
        then parses them."""
        if self.quality >= 10:
            depth = 40 if self.quality >= 11 else 32
            h6 = 96 if self.quality >= 11 else 64
            patience = 24
        else:
            depth = h6 = patience = 0
        max_dist = min((1 << self.wbits) - 16, len(arr))
        return tokenize(arr, max(1, min(9, self.quality)), ZlibStrategy.Default, max_dist,
                        depth=depth, patience=patience, hash6_depth=h6)

    def _write_data_meta_block(self, data: bytes) -> None:
        mlen = len(data)
        arr = np.frombuffer(data, dtype=np.uint8)
        tokens = self.tokenizer(data) if self.device_lz else self._host_tokens(arr)
        use_native = len(tokens[0]) > NATIVE_MIN_TOKENS
        commands = _commands_from_tokens(*tokens)
        start_a, ins_a = commands[:2]
        *plan, cmd_freq, dist_freq, self._ring = _plan_commands(*commands, self._ring,
                                                                use_native)

        # Literal context modelling: every literal's context comes from the
        # two bytes before it, which at encode time are input bytes (the
        # previous meta-block's last two at its start).
        tot_ins = int(ins_a.sum())
        if tot_ins:
            cum = np.concatenate([[0], np.cumsum(ins_a)[:-1]])
            lit_pos_arr = (np.repeat(start_a, ins_a)
                           + np.arange(tot_ins) - np.repeat(cum, ins_a))
        else:
            lit_pos_arr = np.zeros(0, np.int64)
        lit_vals = arr[lit_pos_arr] if len(lit_pos_arr) else np.zeros(0, np.int64)
        if self.mode_name == "Font":
            ctx_enabled = False
        elif self.mode_name == "Text":
            ctx_enabled = self.quality >= 2
        else:
            ctx_enabled = self.quality >= 5
        cmap, lit_codes, cid_of_pos = _context_model(
            arr, lit_pos_arr, lit_vals, enabled=ctx_enabled, tail=self._tail)
        tail2 = (b"\x00\x00" + self._tail)[-2:]
        self._tail = data[-2:]

        cmd_code, dist_code = _write_meta_block_header(self.sink, mlen, cmap, lit_codes,
                                                       cmd_freq, dist_freq)
        _emit_body(self.sink, data, tail2, commands, plan, cmd_code, dist_code, lit_codes, cmap,
                   cid_of_pos, use_native)
