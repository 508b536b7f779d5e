"""Indexed-parallel inflate of the port's own block streams, on the device.

Port of ``compu_tpu/kernels/inflate_jax.py``. The block encode restarts its
parse at every 128-byte output segment and exports each segment's first
bit (``seg_bits``), so a block decodes one lane per segment:

* phase 1, the token scan: kernel P3 (``kernels/inflate_scan.py``), one
  lane a segment, one packed record a token;
* expansion, kernel P7 (``kernels/inflate_resolve.py``): a scatter-max
  of record slot ids at the token starts and a running max give every
  output position its token (slot ids grow with the stream, and a merged
  match's token lives in an earlier lane); each match position's source
  is ``start - dist + (rel mod dist)``, the mod folding overlapping
  copies; int32 roots;
* phase 2, resolution, kernel P6: pointer doubling over the batch's
  positions until every source is a literal, on the reference's schedule
  (whole-map rounds, then rounds over the compacted unresolved set), with
  no host read between the scan and the caller's fetch.

``decode_blocks_indexed`` is the fixed-code route: the same scan as the
dyn route, one token a step for 128 steps, over lookup tables built from
the fixed code's lengths (9-bit codes, so 12 lookup bits hold them).
Stream order, packing and the ``ok`` rule are the reference's, so on the
same inputs ``ok`` and each block's first ``ns[b]`` output bytes equal
the reference's.
"""

from __future__ import annotations

import torch

from ..formats.deflate import consts
from . import inflate_resolve
from .inflate_scan import SEG, inflate_scan, lane_setup

ROW = 4096      # elements a row of the plain expansions' running max


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
    """Each output position's signed root, (B*N,) int32: -(byte + 1) at a
    literal, else the position it copies (``inflate_resolve.expand_indexed``:
    kernel P7 on CUDA, its plain version on the CPU)."""
    return inflate_resolve.expand_indexed(rec, B=B, N=N, S=S, R=R)


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
    """Pointer doubling of the roots to literals; (out u8, ok i32[1])
    (``inflate_resolve.resolve_indexed``: kernel P6 on CUDA, with no host
    read; its plain version on the CPU)."""
    out, ok, _ = inflate_resolve.resolve_indexed(root, ns, ok, N=N)
    return out, ok


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
