"""Indexed-parallel inflate of the port's own block streams, on the device.

Port of ``compu_tpu/kernels/inflate_jax.py``. The block encode restarts its
parse at every 128-byte output segment and exports each segment's first
bit (``seg_bits``), so a block decodes one lane per segment:

* phase 1, the token scan: kernel P3 (``kernels/inflate_scan.py``), one
  lane a segment, one packed record a token;
* expansion: a scatter-max of record slot ids at the token starts and a
  running max give every output position its token (slot ids grow with
  the stream, and a merged match's token lives in an earlier lane); each
  match position's source is ``start - dist + (rel mod dist)``, the mod
  folding overlapping copies;
* phase 2, resolution: pointer doubling over the batch's positions until
  every source is a literal.

``decode_blocks_indexed`` is the fixed-code route: the same scan as the
dyn route, one token a step for 128 steps, over lookup tables built from
the fixed code's lengths (9-bit codes, so 12 lookup bits hold them).
Stream order, packing and the ``ok`` rule are the reference's, so on the
same inputs ``ok`` and each block's first ``ns[b]`` output bytes equal
the reference's.
"""

from __future__ import annotations

import math

import torch

from ..formats.deflate import consts
from .inflate_scan import NO_TOKEN, SEG, inflate_scan, lane_setup

DUMP = 1 << 16  # cells the expansion's scatter drops slots without a token into
ROW = 4096      # elements a row of the expansion's running max


def _scan_ok(seg_bits: torch.Tensor, ns: torch.Tensor, outp: torch.Tensor,
             bad: torch.Tensor) -> torch.Tensor:
    """The scan's consistency check, a 0-dim bool on the device: every lane
    ended exactly at its target and none met a bad token."""
    _, _, target = lane_setup(seg_bits, ns)
    return (outp.to(torch.int64) == target).all() & ~bad.any()


def _decode_with_luts(comps, seg_bits, ns, lit_lut, dist_lut, k: int, rsteps: int,
                      n_out: int):
    """Scan (P3), expand and resolve one batch; (out u8[B*n_out], ok i32[1])."""
    B = comps.shape[0]
    S = n_out // SEG
    if n_out % SEG or tuple(seg_bits.shape) != (B, S):
        raise ValueError(f"seg_bits must be (B, n_out / {SEG}) = {(B, S)}, "
                         f"got {tuple(seg_bits.shape)}")
    rec, outp, bad = inflate_scan(comps, seg_bits, ns, lit_lut, dist_lut, k, rsteps)
    ok = _scan_ok(seg_bits, ns, outp, bad)
    return _expand_and_resolve(rec, ns, ok, B=B, N=n_out, S=S, R=k * rsteps)


def _expand_and_resolve(rec: torch.Tensor, ns: torch.Tensor, ok: torch.Tensor, *,
                        B: int, N: int, S: int, R: int = SEG):
    """Expansion and resolution of a scan's records ``rec`` (B*S, R):
    start in the lane's frame (9 bits, 511 none) | is_lit (1) | payload
    (15). Returns (out u8[B*N], ok i32[1]): ``ok`` is the scan's flag and
    every position below its block's ``ns`` resolved."""
    return _resolve(_expand(rec, B=B, N=N, S=S, R=R), ns, ok, N=N)


def _expand(rec: torch.Tensor, *, B: int, N: int, S: int, R: int) -> torch.Tensor:
    """Each output position's token, by a scatter-max of slot ids at the
    token starts, a running max and one gather; returns the signed roots
    (B*N,) int64: -(byte + 1) at a literal, else the position it copies."""
    dev = rec.device
    L, NT = B * S, B * N
    rec = rec.to(torch.int64).reshape(L, R)
    t_start = rec & 0x1FF
    flat_start = (torch.arange(L, device=dev)[:, None] * SEG + t_start).reshape(-1)
    # Slots without a token (most of them: R is sized for the worst case)
    # land in a dump area past the positions, spread over DUMP cells so
    # their atomic maxima do not queue on one address, and are cut off.
    slot = torch.arange(1, L * R + 1, device=dev)
    dump = NT + SEG + 512
    addr = torch.where(t_start.reshape(-1) < NO_TOKEN, flat_start, dump + (slot & (DUMP - 1)))
    slot_at = torch.zeros(dump + DUMP, dtype=torch.int64, device=dev).scatter_reduce(
        0, addr, slot, "amax")[:NT]
    tokid = torch.clamp(_running_max(slot_at) - 1, 0, L * R - 1)
    rec_of = rec.reshape(-1)[tokid]   # the one expansion gather
    is_lit = ((rec_of >> 9) & 1) > 0
    payload = (rec_of >> 10) & 0x7FFF
    dist = payload + 1
    # A token's start: its lane's base plus the start in the lane's frame
    # (a merged match can start in an earlier lane than the position's).
    start = (tokid // R) * SEG + (rec_of & 0x1FF)
    src = start - dist + torch.remainder(torch.arange(NT, device=dev) - start, dist)
    return torch.where(is_lit, -(payload + 1), torch.clamp(src, 0, NT - 1))


def _running_max(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, 0).values`` of a non-negative (n,) tensor, as a
    running max within rows of ROW elements and the running max of the
    rows' maxima carried in: the same values, with the rows scanned in
    parallel (a 1-D cummax is one long scan on CUDA)."""
    n = x.shape[0]
    rows = torch.nn.functional.pad(x, (0, -n % ROW)).reshape(-1, ROW)
    within = torch.cummax(rows, 1).values
    carry = torch.cummax(within[:, -1], 0).values
    carry = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    return torch.maximum(within, carry[:, None]).reshape(-1)[:n]


def _double(root: torch.Tensor) -> torch.Tensor:
    """One whole-map round: two hops of every unresolved position."""
    for _ in range(2):
        root = torch.where(root >= 0, root[torch.clamp(root, min=0)], root)
    return root


def _double_sub(root: torch.Tensor, cand: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """One round over the compacted positions ``cand``: a hop of each, the
    result written back into ``root`` in place."""
    sub = torch.where(sub >= 0, root[torch.clamp(sub, min=0)], sub)
    root[cand] = sub
    return sub


def _resolve(root: torch.Tensor, ns: torch.Tensor, ok: torch.Tensor, *, N: int):
    """Pointer doubling of the roots to literals; (out u8, ok i32[1]). The
    rounds read their remaining count on the host, once a round."""
    NT = root.shape[0]
    gp = torch.arange(NT, device=root.device)
    valid = (gp % N) < ns.to(torch.int64)[gp // N]
    max_iters = max(1, math.ceil(math.log2(max(NT, 2))))
    ksub = max(SEG, NT // 8)

    def unresolved() -> int:
        return int(((root >= 0) & valid).sum())

    # Whole-map rounds until the unresolved set fits ksub...
    it, left = 0, unresolved()
    while left > ksub and it < max_iters:
        root = _double(root)
        it, left = it + 1, unresolved()
    # ...then rounds over that set alone (the first ksub of it, in order).
    cand = torch.nonzero((root >= 0) & valid).reshape(-1)[:ksub]
    sub = root[cand]
    it = 0
    while it < max_iters and bool((sub >= 0).any()):
        sub = _double_sub(root, cand, sub)
        it += 1
    out = (torch.where(root < 0, -root, 1) - 1).to(torch.uint8)
    ok = ok & torch.where(valid, root < 0, True).all()
    return out, ok.to(torch.int32).reshape(1)


def _fixed_luts(B: int, device):
    """The fixed code's 12-bit lit/len and distance tables, (B, 4096) each."""
    from .inflate_lut import _dist_lut_block, _lit_lut_block   # inflate_lut imports this module

    lit = torch.as_tensor(consts.FIXED_LITLEN_LENGTHS, device=device)[None]
    dist = torch.as_tensor(consts.FIXED_DIST_LENGTHS, device=device)[None]
    return (_lit_lut_block(lit).expand(B, -1).contiguous(),
            _dist_lut_block(dist).expand(B, -1).contiguous())


def decode_blocks_indexed(comps: torch.Tensor, seg_bits: torch.Tensor, ns: torch.Tensor, *,
                          n_out: int):
    """Decode a batch of fixed-code indexed blocks with one scan launch.

    ``comps`` uint8 (B, CAP), CAP a multiple of 16, each row a block's bytes
    and at least 12 zero bytes; ``seg_bits`` int32 (B, n_out / 128);
    ``ns`` int32 (B,). Returns (out u8[B*n_out], ok i32[1]); only each
    block's first ``ns[b]`` bytes of ``out`` are defined."""
    lit_lut, dist_lut = _fixed_luts(comps.shape[0], comps.device)
    return _decode_with_luts(comps, seg_bits, ns, lit_lut, dist_lut, 1, SEG, n_out)


def decode_block_indexed(comp: torch.Tensor, seg_bits: torch.Tensor, n: torch.Tensor, *,
                         n_out: int):
    """Single-block wrapper over :func:`decode_blocks_indexed`."""
    return decode_blocks_indexed(comp[None, :], seg_bits[None, :], n.reshape(1), n_out=n_out)
