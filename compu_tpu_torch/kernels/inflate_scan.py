"""The segment token scan of the indexed DEFLATE inflate, kernel P3.

Port of the phase-1 scan loops of ``compu_tpu/kernels/inflate_jax_lut.py``
(``decode_blocks_indexed_lut``, a ``jax.lax.while_loop`` at :243),
``inflate_jax_dyn.py`` (``decode_blocks_indexed_dyn``, :206) and
``inflate_jax.py`` (``decode_blocks_indexed``, :204). The block encode
restarts its parse at every 128-byte output segment and records each
segment's first bit (``seg_bits``), so one lane decodes one segment's
tokens. Every route is one scan here: per-block lit/len and distance
lookup tables at ``bits`` = 12 or 15 lookup bits (``inflate_lut.py``),
``(k, rsteps)`` = (6, 26) for the LUT route and (1, 128) for the dyn and
fixed routes.

A lane's output is ``[ov, target)`` in its segment's frame: ``ov`` the
overflow of the previous segment's merged match (``seg_bits >> 24``),
``target`` the end of the segment plus the next one's overflow, clamped
to the block's length and to [0, 383]. Each of ``rsteps`` steps starts at
phase ``bit & 127`` and takes up to ``k`` tokens while the phase (grown by
each token's bits) is at most 319: the reference's 384-bit row window as
arithmetic, so a lane takes the tokens the reference takes. Each token is
one packed record: 9-bit start (511 = none), 1-bit is_lit, 15-bit payload
(the byte, or dist - 1). A lane stops at ``target``, or at its first bad
token (EOB, an invalid code or distance), with ``bad`` set; every slot it
did not fill holds exactly 511.

``inflate_scan`` runs the CUDA kernel (``csrc/inflate_scan.cu``) for CUDA
tensors and the plain version, ``inflate_scan_torch``, for CPU tensors.
"""

from __future__ import annotations

import torch

SEG = 128          # output bytes a segment (lane)
NO_TOKEN = 511     # the record of a slot without a token
MAX_PHASE = 319    # a step takes tokens while its phase is at most this


def lane_setup(seg_bits: torch.Tensor, ns: torch.Tensor):
    """Each lane's (first bit, first output, target), (B*S,) int64 each:
    the reference's unpacking of ``seg_bits`` (bits 0..23 the bit offset
    in the block, 24..31 the previous segment's overflow) and its clamps
    (``inflate_jax_lut.py:148-163``). Inert lanes (stored blocks, empty
    slots: ``ns`` 0) start at their target."""
    B, S = seg_bits.shape
    sb = seg_bits.to(torch.int64)
    ov = (sb >> 24) & 0xFF
    ov_next = torch.cat([ov[:, 1:], torch.zeros_like(ov[:, :1])], 1)
    seg = torch.arange(S, device=sb.device)
    target = torch.clamp(torch.minimum((seg + 1) * SEG + ov_next,
                                       ns.to(torch.int64)[:, None]) - seg * SEG,
                         0, SEG + 255)
    return ((sb & 0xFFFFFF).reshape(-1), torch.minimum(ov, target).reshape(-1),
            target.reshape(-1))


def _check_scan(comps, seg_bits, ns, lit_lut, dist_lut, k: int, rsteps: int):
    """Validate the shapes; returns the lookup bits."""
    if comps.dim() != 2 or comps.shape[1] % 16 or comps.shape[1] < 16:
        raise ValueError(f"comps must be (B, CAP) with CAP a multiple of 16, "
                         f"got {tuple(comps.shape)}")
    B = comps.shape[0]
    if seg_bits.dim() != 2 or seg_bits.shape[0] != B or seg_bits.shape[1] < 1:
        raise ValueError(f"seg_bits must be (B={B}, S >= 1), got {tuple(seg_bits.shape)}")
    if tuple(ns.shape) != (B,):
        raise ValueError(f"ns must be ({B},), got {tuple(ns.shape)}")
    width = lit_lut.shape[1] if lit_lut.dim() == 2 else 0
    bits = width.bit_length() - 1
    if bits not in (12, 15) or width != 1 << bits:
        raise ValueError(f"lit_lut must be (B, 2^12) or (B, 2^15), got {tuple(lit_lut.shape)}")
    for name, t in (("lit_lut", lit_lut), ("dist_lut", dist_lut)):
        if tuple(t.shape) != (B, width):
            raise ValueError(f"{name} must be {(B, width)}, got {tuple(t.shape)}")
    if not (1 <= k <= 8 and 1 <= rsteps <= 256):
        raise ValueError(f"k must be in 1..8 and rsteps in 1..256, got {k}, {rsteps}")
    return bits


def inflate_scan_torch(comps, seg_bits, ns, lit_lut, dist_lut, k: int, rsteps: int):
    """Plain version: one loop iteration a token slot, vectorised over lanes.

    ``comps`` (B, CAP) uint8, each block's bytes with at least 12 zero bytes
    of pad (bits past the end of the whole array read as 0); ``seg_bits``
    (B, S) int32; ``ns`` (B,) int32; ``lit_lut``/``dist_lut`` (B, 2^bits)
    int32 packed records (``inflate_lut._lit_lut_block``/``_dist_lut_block``).
    Returns ``rec`` (B*S, k*rsteps) int32 (slot ``t*k + j``: token j of step
    t), ``outp`` (B*S,) int32, ``bad`` (B*S,) bool."""
    bits = _check_scan(comps, seg_bits, ns, lit_lut, dist_lut, k, rsteps)
    B, CAP = comps.shape
    S = seg_bits.shape[1]
    dev = comps.device
    mask = (1 << bits) - 1
    c4 = comps.reshape(-1, 4).to(torch.int64)
    words = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    nwords = words.shape[0]
    words = torch.cat([words, torch.zeros(3, dtype=torch.int64, device=dev)])
    blk = torch.arange(B * S, device=dev) // S
    lit = lit_lut.to(torch.int64).reshape(-1)
    dist_t = dist_lut.to(torch.int64).reshape(-1)
    lut_base = blk << bits
    bit, outp, target = lane_setup(seg_bits, ns)
    gbase = blk * (CAP * 8)
    bad = torch.zeros(B * S, dtype=torch.bool, device=dev)
    rec = torch.full((B * S, k * rsteps), NO_TOKEN, dtype=torch.int64, device=dev)
    for t in range(rsteps):
        active = (outp < target) & ~bad
        if not bool(active.any()):
            break
        ph = bit & 127
        for j in range(k):
            live = active & (ph <= MAX_PHASE)
            # The 63 stream bits from the lane's bit: a token needs 48 at most.
            gbit = gbase + bit
            q = torch.clamp(gbit >> 5, max=nwords)
            sh = gbit & 31
            w0, w1, w2 = words[q], words[q + 1], words[q + 2]
            lo = ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF
            hi = ((w1 >> sh) | (w2 << (32 - sh))) & 0x7FFFFFFF
            win = lo | (hi << 32)
            a = lit[lut_base + (win & mask)]
            kind, clen, lxb, arg = a & 3, (a >> 2) & 15, (a >> 6) & 7, (a >> 9) & 0xFF
            mlen = 3 + arg + ((win >> clen) & ((1 << lxb) - 1))
            wd = win >> (clen + lxb)
            d = dist_t[lut_base + (wd & mask)]
            dlen, dxb = (d >> 1) & 15, (d >> 5) & 15
            dist = 1 + ((d >> 9) & 0x7FFF) + ((wd >> dlen) & ((1 << dxb) - 1))
            is_lit = live & (kind == 0)
            is_m = live & (kind == 1) & ((d & 1) == 1)
            took = is_lit | is_m
            payload = torch.where(is_lit, arg, dist - 1)
            rec[:, t * k + j] = torch.where(took, outp | (is_lit.to(torch.int64) << 9)
                                            | (payload << 10), NO_TOKEN)
            adv = torch.where(is_lit, clen, torch.where(is_m, clen + lxb + dlen + dxb, 0))
            bit = bit + adv
            ph = ph + adv
            outp = outp + torch.where(is_lit, 1, torch.where(is_m, mlen, 0))
            bad = bad | (live & ~took)
            active = active & took & (outp < target)
    return rec.to(torch.int32), outp.to(torch.int32), bad


def inflate_scan_cuda(comps, seg_bits, ns, lit_lut, dist_lut, k: int, rsteps: int):
    """The CUDA kernel (``csrc/inflate_scan.cu``); same contract as
    :func:`inflate_scan_torch`. ``comps``, ``lit_lut`` and ``dist_lut``
    must be 16-byte aligned (they are copied into shared memory 16 bytes at
    a time), and a block's record rows must fit its shared memory
    (``k * rsteps`` of 171 or less fits at 12 bits, 203 or less at 15)."""
    from .. import _build

    _build.require(comps, "comps", ndim=2, dtype=torch.uint8)
    for name, t, ndim in (("seg_bits", seg_bits, 2), ("ns", ns, 1),
                          ("lit_lut", lit_lut, 2), ("dist_lut", dist_lut, 2)):
        _build.require(t, name, ndim=ndim, dtype=torch.int32)
        if t.device != comps.device:
            raise ValueError(f"{name} must be on {comps.device}")
    bits = _check_scan(comps, seg_bits, ns, lit_lut, dist_lut, k, rsteps)
    for name, t in (("comps", comps), ("lit_lut", lit_lut), ("dist_lut", dist_lut)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not _build.lib().compu_inflate_scan_smem(bits, k, rsteps):
        raise ValueError(f"k * rsteps = {k * rsteps} record slots a lane do not fit the "
                         f"kernel's shared memory")
    B, CAP = comps.shape
    S = seg_bits.shape[1]
    dev = comps.device
    rec = torch.empty(B * S, k * rsteps, dtype=torch.int32, device=dev)
    outp = torch.empty(B * S, dtype=torch.int32, device=dev)
    bad = torch.empty(B * S, dtype=torch.bool, device=dev)
    err = _build.lib().compu_inflate_scan(
        comps.data_ptr(), CAP, B, seg_bits.data_ptr(), S, ns.data_ptr(),
        lit_lut.data_ptr(), dist_lut.data_ptr(), bits, k, rsteps,
        rec.data_ptr(), outp.data_ptr(), bad.data_ptr(), _build.stream_handle(comps))
    _build.check_launch(err, "inflate_scan")
    return rec, outp, bad


def inflate_scan(comps, seg_bits, ns, lit_lut, dist_lut, k: int, rsteps: int):
    """The token scan: the kernel on CUDA, the plain version on the CPU."""
    kind = comps.device.type
    if kind == "cuda":
        return inflate_scan_cuda(comps, seg_bits, ns, lit_lut, dist_lut, k, rsteps)
    if kind == "cpu":
        return inflate_scan_torch(comps, seg_bits, ns, lit_lut, dist_lut, k, rsteps)
    raise ValueError(f"no inflate_scan for device {comps.device}")
