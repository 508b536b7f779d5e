"""Speculative-resync inflate of foreign (unindexed) DEFLATE streams, on the
device: the speculative chunk scan, kernel P4, and the stream-global
resolution.

Port of ``compu_tpu/kernels/inflate_spec.py``. A foreign block's token
boundaries are unknown, but a literal/length token with its distance is at
most 48 bits, so the decode enters a C-bit chunk at one of 48 bit offsets
past the chunk's start. Each (chunk, phase) lane decodes speculatively from
its own entry bit with 15-bit direct lookup tables, up to KF tokens a step,
recording its tokens and its exit phase into the next chunk. The true path
is the orbit of the exit phases from the block's first token bit: a walk
over the wave's chunks on the host (``formats/deflate/device_inflate.py``),
after which the true lanes' records are the block's tokens. Their
expansion and back-reference resolution is stream-global, since the window
crosses deflate blocks.

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
records, slot ``t*KF + j`` for token j of step t: outlen (9) | is_lit (1) |
payload (15: the byte, or dist - 1). A slot that emits nothing holds 0
(the reference leaves ``payload << 10`` there; it reads only slots with
outlen > 0, and so does the driver).

``spec_scan_wave`` runs the CUDA kernel (``csrc/inflate_spec.cu``) for
CUDA tensors and the plain version, ``spec_scan_wave_torch``, for CPU
tensors. The reference's 12-word row view of the stream and its column
select (``make_comp12``, ``_mux12``) were TPU workarounds for a per-lane
gather; here a lane reads its bits by position from the padded stream
(``pad_stream``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .inflate import _double, _running_max
from .inflate_lut import _dist_lut_block, _lit_lut_block

FBITS = 15          # RFC max code length: foreign streams use the full range
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


def build_foreign_luts(lit_lens: torch.Tensor, dist_lens: torch.Tensor):
    """15-bit direct tables, (2^15,) int32 each, for one block's
    host-parsed code lengths ((288,) and (30,))."""
    return (_lit_lut_block(lit_lens[None], FBITS)[0].contiguous(),
            _dist_lut_block(dist_lens[None], FBITS)[0].contiguous())


def pad_stream(data: bytes, device) -> torch.Tensor:
    """The stream as a (N,) uint8 tensor on ``device``, N a multiple of 16
    with at least PAD_BYTES zero bytes past the data: bits past the stream
    read as zero."""
    n = len(data)
    buf = np.zeros(n + (-n % 16) + PAD_BYTES, np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf).to(device)


def _check_wave(comp, lit_lut, dist_lut, wave_bit0: int, total_bits: int) -> None:
    if comp.dim() != 1 or comp.dtype != torch.uint8 or comp.numel() % 4:
        raise ValueError(f"comp must be a (N,) uint8 tensor, N a multiple of 4, got "
                         f"{tuple(comp.shape)} {comp.dtype}")
    for name, t in (("lit_lut", lit_lut), ("dist_lut", dist_lut)):
        if tuple(t.shape) != (1 << FBITS,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a ({1 << FBITS},) int32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not (0 <= wave_bit0 and 0 <= total_bits <= 8 * comp.numel()):
        raise ValueError(f"wave_bit0 {wave_bit0} and total_bits {total_bits} must lie in "
                         f"the stream of {comp.numel()} bytes")
    if max(wave_bit0, total_bits) + WAVE_CHUNKS * C + RF * PHASES >= 1 << 31:
        raise ValueError("the wave's bit offsets must fit int32")


def spec_scan_wave_torch(comp, lit_lut, dist_lut, wave_bit0: int, total_bits: int):
    """Plain version: one loop iteration a token slot, vectorised over the
    lanes. ``comp`` (N,) uint8, the padded stream (:func:`pad_stream`);
    ``lit_lut``/``dist_lut`` (2^15,) int32 packed records
    (:func:`build_foreign_luts`); ``wave_bit0`` the bit of the wave's first
    chunk; ``total_bits`` the stream's length in bits. Returns ``lanes``
    (5, L) int32 (exit_rel, eob_bit, flags, nrec, outp) and ``rec`` (RF, L)
    int32."""
    _check_wave(comp, lit_lut, dist_lut, wave_bit0, total_bits)
    dev = comp.device
    c4 = comp.reshape(-1, 4).to(torch.int64)
    words = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    nwords = words.shape[0]
    words = torch.cat([words, torch.zeros(3, dtype=torch.int64, device=dev)])
    lit = lit_lut.to(torch.int64)
    dist_t = dist_lut.to(torch.int64)
    mask = (1 << FBITS) - 1
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
        for j in range(KF):
            live = ~done & (bit < limit)
            # The 63 stream bits from the lane's bit: a token needs 48 at most.
            q = torch.clamp(bit >> 5, max=nwords)
            sh = bit & 31
            w0, w1, w2 = words[q], words[q + 1], words[q + 2]
            lo = ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF
            hi = ((w1 >> sh) | (w2 << (32 - sh))) & 0x7FFFFFFF
            win = lo | (hi << 32)
            a = lit[win & mask]
            kind, clen, lxb, arg = a & 3, (a >> 2) & 15, (a >> 6) & 7, (a >> 9) & 0xFF
            mlen = 3 + arg + ((win >> clen) & ((1 << lxb) - 1))
            wd = win >> (clen + lxb)
            d = dist_t[wd & mask]
            dlen, dxb = (d >> 1) & 15, (d >> 5) & 15
            dist = 1 + ((d >> 9) & 0x7FFF) + ((wd >> dlen) & ((1 << dxb) - 1))
            is_lit = live & (kind == 0)
            is_m = live & (kind == 1)
            is_eob = live & (kind == 2)
            bad = bad | (live & (kind == 3)) | (is_m & ((d & 1) == 0))
            emit = is_lit | is_m
            outlen = torch.where(is_lit, 1, torch.where(is_m, mlen, 0))
            payload = torch.where(is_lit, arg, dist - 1)
            rec[t * KF + j] = torch.where(emit, outlen | (is_lit.to(torch.int64) << 9)
                                          | (payload << 10), 0)
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


def spec_scan_wave_cuda(comp, lit_lut, dist_lut, wave_bit0: int, total_bits: int):
    """The CUDA kernel (``csrc/inflate_spec.cu``); same contract as
    :func:`spec_scan_wave_torch`. ``comp`` must be 4-byte aligned."""
    from .. import _build

    _build.require(comp, "comp", ndim=1, dtype=torch.uint8)
    for name, t in (("lit_lut", lit_lut), ("dist_lut", dist_lut)):
        _build.require(t, name, ndim=1, dtype=torch.int32)
        if t.device != comp.device:
            raise ValueError(f"{name} must be on {comp.device}")
    _check_wave(comp, lit_lut, dist_lut, wave_bit0, total_bits)
    if comp.data_ptr() % 4:
        raise ValueError("comp must be 4-byte aligned")
    lanes = torch.empty(5, LANES, dtype=torch.int32, device=comp.device)
    rec = torch.empty(RF, LANES, dtype=torch.int32, device=comp.device)
    err = _build.lib().compu_inflate_spec(
        comp.data_ptr(), comp.numel() // 4, lit_lut.data_ptr(), dist_lut.data_ptr(),
        wave_bit0, total_bits, lanes.data_ptr(), rec.data_ptr(), _build.stream_handle(comp))
    _build.check_launch(err, "inflate_spec")
    return lanes, rec


def spec_scan_wave(comp, lit_lut, dist_lut, wave_bit0: int, total_bits: int):
    """The speculative scan of one wave: the kernel on CUDA, the plain
    version on the CPU."""
    kind = comp.device.type
    if kind == "cuda":
        return spec_scan_wave_cuda(comp, lit_lut, dist_lut, wave_bit0, total_bits)
    if kind == "cpu":
        return spec_scan_wave_torch(comp, lit_lut, dist_lut, wave_bit0, total_bits)
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
