"""Speculative-resync inflate of foreign (unindexed) DEFLATE streams, on the
device: the block's code tables, the speculative chunk scan, kernel P4,
and the stream-global resolution.

Port of ``compu_tpu/kernels/inflate_spec.py``. A foreign block's token
boundaries are unknown, but a literal/length token with its distance is at
most 48 bits, so the decode enters a C-bit chunk at one of 48 bit offsets
past the chunk's start. Each (chunk, phase) lane decodes speculatively from
its own entry bit, up to KF tokens a step, recording its tokens and its
exit phase into the next chunk. The true path is the orbit of the exit
phases from the block's first token bit: a walk over the wave's chunks on
the host (``formats/deflate/device_inflate.py``), after which the true
lanes' records are the block's tokens. Their expansion and back-reference
resolution is stream-global, since the window crosses deflate blocks.

The block's code tables (:func:`build_foreign_tables`) are one (TABLE_WORDS,)
int32 tensor: 12-bit direct primaries of the lit/len and distance codes,
in the packed layouts of ``inflate_lut`` (lit/len: kind (2) | clen (4) |
lxb (3) | arg (8); distance: valid (1) | dlen (4) | dxb (4) | base - 1
(15)); each code's canonical ``first``, ``count`` and ``base`` for the
lengths 1..15; and the packed records of its symbols in canonical order.
A window whose primary entry is invalid (no code of 12 bits or fewer fits)
walks the lengths 13..15: the first whose canonical range holds the
window's code gives its symbol's record, else the primary entry stands.
That lookup equals the reference's 15-bit direct tables on every 15-bit
window, for any code lengths (incomplete, oversubscribed, one symbol, none,
the fixed code's phantom symbols 286/287): a window's code fits at most one
length, since each length's codes start past every longer code's prefix.

A wave is WAVE_CHUNKS chunks x PHASES phases = 12,288 lanes. A lane runs
at most FSTEPS steps. A step starts at the 128-bit group that holds the
lane's bit and takes tokens while their start lies at most 319 bits past
that group's start, at most KF a step. A lane retires after the token that
reaches its chunk's end, at EOB, at ``total_bits`` or at a bad token (an
invalid code or distance), and starts retired when its first bit is at or
past ``total_bits``. A lane not retired after FSTEPS steps has overflowed
its RF record slots (more than 192 tokens in one 512-bit chunk: codes of 2
bits or fewer) and is bad; the driver refuses such a stream, as the
reference's does.

Per lane the scan returns, in rows of one (5, L) int32 tensor:
``exit_rel`` = clip(bit - chunk_end, 0, 47), ``eob_bit`` (the EOB token's
end bit, or -1), ``flags`` (bit 0 EOB, bit 1 bad or overflow), ``nrec``
and ``outp`` (records and output bytes emitted); and the (RF, L) int32
records: the lane's k-th literal or match is slot k, outlen (9) | is_lit
(1) | payload (15: the byte, or dist - 1). Only slots below the lane's
``nrec`` are defined (the kernel leaves the others unwritten, the plain
version 0; the reference puts its tokens at slot t*KF + j of step t and
``payload << 10`` in slots that emit nothing).

``spec_scan_wave`` runs the CUDA kernel (``csrc/inflate_spec.cu``) for
CUDA tensors and the plain version, ``spec_scan_wave_torch``, for CPU
tensors. The reference's 12-word row view of the stream and its column
select (``make_comp12``, ``_mux12``) were TPU workarounds for a per-lane
gather; here a lane reads its bits by position from the padded stream
(``pad_stream``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..formats.deflate import consts
from .inflate import _double, _running_max

MAXB = 15           # RFC max code length: foreign streams use the full range
PHASES = 48         # max token bits: 15 + 5 + 15 + 13
C = 512             # chunk bits per speculative lane
WAVE_CHUNKS = 256   # chunks per launch (16 KiB of compressed bits)
KF = 4              # token slots per step
RF = 192            # record slots per lane
FSTEPS = RF // KF
LANES = WAVE_CHUNKS * PHASES
MAX_PHASE = 319     # a step takes tokens starting at most this far past its group
PAD_BYTES = 16      # zero bytes past the stream: a token's 64-bit window stays inside
# Pointer-doubling rounds between two reads of the unresolved count: the
# roots do not change once every one is a literal, so later rounds are
# idempotent, and the host waits for the device once per group.
ROUNDS_PER_CHECK = 4

# The block's code tables, in int32 words (build_foreign_tables): the two
# primaries, then per code (lit/len, distance) and length l = 1..15 its
# canonical (first, count, base), then each code's packed records in
# canonical order (288 and 30).
PRIM_BITS = 12
LIT_PRIM = 0
DIST_PRIM = 1 << PRIM_BITS
CANON = 2 << PRIM_BITS
LIT_SYMS = CANON + 2 * MAXB * 3
DIST_SYMS = LIT_SYMS + 288
TABLE_WORDS = -(-(DIST_SYMS + 30) // 4) * 4   # whole 16-byte units


@functools.lru_cache(maxsize=1)
def _rev15() -> np.ndarray:
    """(2^15,) int64: each 15-bit value with its bits reversed."""
    v = np.arange(1 << MAXB)
    rev = np.zeros_like(v)
    for i in range(MAXB):
        rev |= ((v >> i) & 1) << (MAXB - 1 - i)
    return rev


def _pack_lit(sym, clen, ok):
    """Packed lit/len records (``inflate_lut._lit_lut_block``'s layout)."""
    is_lit = ok & (sym < 256)
    is_eob = ok & (sym == 256)
    is_match = ok & (sym > 256) & (sym < 286)
    code = np.clip(sym - 257, 0, 28)
    kind = np.where(is_lit, 0, np.where(is_match, 1, np.where(is_eob, 2, 3)))
    arg = np.where(is_lit, sym, consts.LENGTH_BASE[code] - 3)
    lxb = np.where(is_match, consts.LENGTH_EXTRA[code], 0)
    return kind | (np.clip(clen, 1, 15) << 2) | (lxb << 6) | (np.clip(arg, 0, 255) << 9)


def _pack_dist(sym, clen, ok):
    """Packed distance records (``inflate_lut._dist_lut_block``'s layout)."""
    s = np.clip(sym, 0, 29)
    return ((ok & (sym < 30)).astype(np.int64) | (np.clip(clen, 1, 15) << 1)
            | (consts.DIST_EXTRA[s].astype(np.int64) << 5)
            | ((consts.DIST_BASE[s].astype(np.int64) - 1) << 9))


def _code_tables(lengths: np.ndarray, pack):
    """One code's part of the tables: its primary (2^PRIM_BITS,), its
    canonical (first, count, base) for lengths 1..15 as (15, 3), and its
    packed records in canonical order (A,).

    A primary entry is the record of the code of PRIM_BITS bits or fewer
    that the window's first bits spell, else the reference's entry for a
    window no code fits: the symbol at canonical position ``cand1`` (the
    window's first bit), length 1, invalid."""
    A = lengths.shape[0]
    lengths = lengths.astype(np.int64)
    count = np.bincount(lengths, minlength=MAXB + 1)[1:MAXB + 1]
    first = np.zeros(MAXB, np.int64)
    for i in range(1, MAXB):
        first[i] = (first[i - 1] + count[i - 1]) << 1
    base = np.cumsum(count) - count
    symlist = np.argsort(np.where(lengths > 0, lengths, 99) * (2 * A) + np.arange(A),
                         kind="stable")
    slen = lengths[symlist]
    syms = pack(symlist, slen, slen > 0)
    prim = np.tile(pack(symlist[:2], 1, False), 1 << (PRIM_BITS - 1))
    # Each code of l <= PRIM_BITS bits fills the windows whose first l bits
    # spell it: its reversed code plus every value of the bits above.
    k = np.nonzero((slen >= 1) & (slen <= PRIM_BITS))[0]
    lk = slen[k]
    code = first[lk - 1] + k - base[lk - 1]
    fits = code < (1 << lk)
    k, lk, code = k[fits], lk[fits], code[fits]
    rev = _rev15()[code << (MAXB - lk)]
    reps = 1 << (PRIM_BITS - lk)
    group = np.repeat(np.cumsum(reps) - reps, reps)
    high = np.arange(int(reps.sum())) - group
    prim[np.repeat(rev, reps) + (high << np.repeat(lk, reps))] = np.repeat(syms[k], reps)
    return prim, np.stack([first, count, base], 1), syms


def build_foreign_tables(lit_lens, dist_lens, device="cpu") -> torch.Tensor:
    """The block's code tables, (TABLE_WORDS,) int32 on ``device``, from its
    host-parsed code lengths ((288,) and (30,), numpy): built in numpy on
    the host, then one upload."""
    out = np.zeros(TABLE_WORDS, np.int64)
    for prim0, syms0, canon0, lens, pack in (
            (LIT_PRIM, LIT_SYMS, CANON, lit_lens, _pack_lit),
            (DIST_PRIM, DIST_SYMS, CANON + MAXB * 3, dist_lens, _pack_dist)):
        prim, canon, syms = _code_tables(np.asarray(lens), pack)
        out[prim0:prim0 + (1 << PRIM_BITS)] = prim
        out[canon0:canon0 + MAXB * 3] = canon.reshape(-1)
        out[syms0:syms0 + syms.shape[0]] = syms
    return torch.from_numpy(out.astype(np.int32)).to(device)


def lookup_foreign(tables: torch.Tensor, win: torch.Tensor, dist: bool) -> torch.Tensor:
    """The packed record of each window (int64, its first 15 bits LSB
    first) in one code of ``tables``: the primary entry, or, where it is
    invalid, the walk over the lengths PRIM_BITS + 1 .. 15. Equals the
    reference's 15-bit direct table at the window."""
    t = tables.to(torch.int64)
    prim0, syms0, canon0, A = ((DIST_PRIM, DIST_SYMS, CANON + MAXB * 3, 30) if dist
                               else (LIT_PRIM, LIT_SYMS, CANON, 288))
    a = t[prim0 + (win & ((1 << PRIM_BITS) - 1))]
    need = (a & 1) == 0 if dist else (a & 3) == 3
    if not bool(need.any()):
        return a
    rev = torch.from_numpy(_rev15()).to(win.device)[win[need] & ((1 << MAXB) - 1)]
    canon = t[canon0:canon0 + MAXB * 3].reshape(MAXB, 3).tolist()
    long = a[need]
    for length in range(MAXB, PRIM_BITS, -1):   # at most one length fits
        first, count, base = canon[length - 1]
        code = rev >> (MAXB - length)
        fit = (code >= first) & (code < first + count)
        long = torch.where(fit, t[syms0 + torch.clamp(base + code - first, 0, A - 1)], long)
    a[need] = long
    return a


def pad_stream(data: bytes, device) -> torch.Tensor:
    """The stream as a (N,) uint8 tensor on ``device``, N a multiple of 16
    with at least PAD_BYTES zero bytes past the data: bits past the stream
    read as zero."""
    n = len(data)
    buf = np.zeros(n + (-n % 16) + PAD_BYTES, np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf).to(device)


def _check_wave(comp, tables, wave_bit0: int, total_bits: int) -> None:
    if comp.dim() != 1 or comp.dtype != torch.uint8 or comp.numel() % 4:
        raise ValueError(f"comp must be a (N,) uint8 tensor, N a multiple of 4, got "
                         f"{tuple(comp.shape)} {comp.dtype}")
    if tuple(tables.shape) != (TABLE_WORDS,) or tables.dtype != torch.int32:
        raise ValueError(f"tables must be a ({TABLE_WORDS},) int32 tensor, got "
                         f"{tuple(tables.shape)} {tables.dtype}")
    if not (0 <= wave_bit0 and 0 <= total_bits <= 8 * comp.numel()):
        raise ValueError(f"wave_bit0 {wave_bit0} and total_bits {total_bits} must lie in "
                         f"the stream of {comp.numel()} bytes")
    if max(wave_bit0, total_bits) + WAVE_CHUNKS * C + RF * PHASES >= 1 << 31:
        raise ValueError("the wave's bit offsets must fit int32")


def spec_scan_wave_torch(comp, tables, wave_bit0: int, total_bits: int):
    """Plain version: one loop iteration a token slot of the reference's
    steps, vectorised over the lanes. ``comp`` (N,) uint8, the padded
    stream (:func:`pad_stream`); ``tables`` the block's code tables
    (:func:`build_foreign_tables`); ``wave_bit0`` the bit of the wave's
    first chunk; ``total_bits`` the stream's length in bits. Returns
    ``lanes`` (5, L) int32 (exit_rel, eob_bit, flags, nrec, outp) and
    ``rec`` (RF, L) int32, 0 past each lane's ``nrec``."""
    _check_wave(comp, tables, wave_bit0, total_bits)
    dev = comp.device
    c4 = comp.reshape(-1, 4).to(torch.int64)
    words = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    nwords = words.shape[0]
    words = torch.cat([words, torch.zeros(3, dtype=torch.int64, device=dev)])
    lane = torch.arange(LANES, device=dev)
    chunk_end = wave_bit0 + (lane // PHASES + 1) * C
    bit = chunk_end - C + lane % PHASES
    done = bit >= total_bits
    eob = torch.zeros(LANES, dtype=torch.bool, device=dev)
    bad = torch.zeros_like(eob)
    eob_bit = torch.full((LANES,), -1, dtype=torch.int64, device=dev)
    outp = torch.zeros(LANES, dtype=torch.int64, device=dev)
    nrec = torch.zeros_like(outp)
    rec = torch.zeros((RF, LANES), dtype=torch.int64, device=dev)
    for t in range(FSTEPS):
        if bool(done.all()):
            break
        # Tokens of this step start before the bit at phase 320 of the
        # 128-bit group that holds the lane's bit.
        limit = (bit & ~127) + MAX_PHASE + 1
        for _ in range(KF):
            live = ~done & (bit < limit)
            # The 63 stream bits from the lane's bit: a token needs 48 at most.
            q = torch.clamp(bit >> 5, max=nwords)
            sh = bit & 31
            w0, w1, w2 = words[q], words[q + 1], words[q + 2]
            lo = ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF
            hi = ((w1 >> sh) | (w2 << (32 - sh))) & 0x7FFFFFFF
            win = lo | (hi << 32)
            a = lookup_foreign(tables, win, dist=False)
            kind, clen, lxb, arg = a & 3, (a >> 2) & 15, (a >> 6) & 7, (a >> 9) & 0xFF
            mlen = 3 + arg + ((win >> clen) & ((1 << lxb) - 1))
            wd = win >> (clen + lxb)
            d = lookup_foreign(tables, wd, dist=True)
            dlen, dxb = (d >> 1) & 15, (d >> 5) & 15
            dist = 1 + ((d >> 9) & 0x7FFF) + ((wd >> dlen) & ((1 << dxb) - 1))
            is_lit = live & (kind == 0)
            is_m = live & (kind == 1)
            is_eob = live & (kind == 2)
            bad = bad | (live & (kind == 3)) | (is_m & ((d & 1) == 0))
            emit = is_lit | is_m
            outlen = torch.where(is_lit, 1, torch.where(is_m, mlen, 0))
            payload = torch.where(is_lit, arg, dist - 1)
            rec[nrec[emit], lane[emit]] = (outlen | (is_lit.to(torch.int64) << 9)
                                           | (payload << 10))[emit]
            eob_bit = torch.where(is_eob, bit + clen, eob_bit)
            eob = eob | is_eob
            bit = bit + torch.where(is_lit | is_eob, clen,
                                    torch.where(is_m, clen + lxb + dlen + dxb, 0))
            outp = outp + outlen
            nrec = nrec + emit.to(torch.int64)
            done = done | is_eob | bad | (bit >= chunk_end) | (bit >= total_bits)
    bad = bad | ~done  # record-slot overflow
    exit_rel = torch.clamp(bit - chunk_end, 0, PHASES - 1)
    flags = eob.to(torch.int64) | (bad.to(torch.int64) << 1)
    lanes = torch.stack([exit_rel, eob_bit, flags, nrec, outp])
    return lanes.to(torch.int32), rec.to(torch.int32)


def spec_scan_wave_cuda(comp, tables, wave_bit0: int, total_bits: int):
    """The CUDA kernel (``csrc/inflate_spec.cu``); same contract as
    :func:`spec_scan_wave_torch`, but the record slots at and past each
    lane's ``nrec`` are left unwritten. ``comp`` must be 4-byte aligned and
    ``tables`` 16-byte aligned."""
    from .. import _build

    _build.require(comp, "comp", ndim=1, dtype=torch.uint8)
    _build.require(tables, "tables", ndim=1, dtype=torch.int32)
    if tables.device != comp.device:
        raise ValueError(f"tables must be on {comp.device}")
    _check_wave(comp, tables, wave_bit0, total_bits)
    if comp.data_ptr() % 4 or tables.data_ptr() % 16:
        raise ValueError("comp must be 4-byte aligned and tables 16-byte aligned")
    lanes = torch.empty(5, LANES, dtype=torch.int32, device=comp.device)
    rec = torch.empty(RF, LANES, dtype=torch.int32, device=comp.device)
    err = _build.lib().compu_inflate_spec(
        comp.data_ptr(), comp.numel() // 4, tables.data_ptr(), wave_bit0, total_bits,
        lanes.data_ptr(), rec.data_ptr(), _build.stream_handle(comp))
    _build.check_launch(err, "inflate_spec")
    return lanes, rec


def spec_scan_wave(comp, tables, wave_bit0: int, total_bits: int):
    """The speculative scan of one wave: the kernel on CUDA, the plain
    version on the CPU."""
    kind = comp.device.type
    if kind == "cuda":
        return spec_scan_wave_cuda(comp, tables, wave_bit0, total_bits)
    if kind == "cpu":
        return spec_scan_wave_torch(comp, tables, wave_bit0, total_bits)
    raise ValueError(f"no spec_scan_wave for device {comp.device}")


def resolve_foreign(outlens: torch.Tensor, is_lit: torch.Tensor, payload: torch.Tensor,
                    starts: torch.Tensor, stored_out: torch.Tensor, stored_mask: torch.Tensor,
                    *, total_out: int):
    """Stream-global expansion and back-reference resolution of an ordered
    token list (the true paths of every block, in stream order).

    ``outlens``/``is_lit``/``payload``/``starts``: (T,) tokens, each with
    outlen > 0 and its first output position; ``stored_out``/``stored_mask``:
    (total_out,) bytes and mask of the stored blocks' ranges (their
    positions are literal roots). Returns (out u8[total_out], ok i32[1]).

    The reference pads the tokens and positions to powers of two (its
    shapes are static); here both are the real ones. Every output position
    takes the last token that starts at or before it (a scatter of token
    ids at their starts, then a running max); a match position's source is
    ``start - dist + (rel mod dist)``. Pointer doubling, two hops a round,
    then resolves every source to a literal, with the reference's limit of
    ceil(log2 NT) rounds, NT its padded length; the unresolved count is
    read every ROUNDS_PER_CHECK rounds."""
    dev = stored_out.device
    NT = total_out
    T = outlens.shape[0]
    starts = starts.to(torch.int64)
    pay = payload.to(torch.int64)
    slot_at = torch.zeros(NT, dtype=torch.int64, device=dev)
    slot_at[starts] = torch.arange(1, T + 1, device=dev)   # starts are distinct
    tokid = torch.clamp(_running_max(slot_at) - 1, 0, max(T - 1, 0))
    if T:
        start_of = starts[tokid]
        pay_of = pay[tokid]
        lit_of = is_lit[tokid] != 0
        dist_of = pay_of + 1
        gp = torch.arange(NT, device=dev)
        src = start_of - dist_of + torch.remainder(gp - start_of, dist_of)
        root = torch.where(lit_of, -(pay_of + 1), torch.clamp(src, 0, NT - 1))
    else:
        root = torch.zeros(NT, dtype=torch.int64, device=dev)
    root = torch.where(stored_mask, -(stored_out.to(torch.int64) + 1), root)

    max_iters = max(12, math.ceil(math.log2(max(NT, 2))))   # log2 of the reference's NT
    it = 0
    while it < max_iters and bool((root >= 0).any()):
        for _ in range(min(ROUNDS_PER_CHECK, max_iters - it)):
            root = _double(root)
            it += 1
    out = (torch.where(root < 0, -root, 1) - 1).to(torch.uint8)
    ok = (root < 0).all()
    return out, ok.to(torch.int32).reshape(1)
