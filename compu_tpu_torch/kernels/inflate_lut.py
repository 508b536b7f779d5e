"""The LUT route of the indexed DEFLATE inflate: per-block direct lookup
tables and the multi-token scan.

Port of ``compu_tpu/kernels/inflate_jax_lut.py``. Each block's lit/len and
distance codes become direct tables over every ``nbits``-bit LSB-first
window (2^12 entries for the encoder's codes, which are at most 12 bits;
2^15, the RFC maximum, for the dyn route), built densely on the device
from the host-parsed code lengths by canonical arithmetic, with the
reference's packed record layouts:

* lit/len: kind (2) | clen (4) | lxb (3) | arg (8); kind 0 literal (arg =
  the byte), 1 match (arg = length base - 3), 2 EOB, 3 invalid;
* dist: valid (1) | dlen (4) | dxb (4) | dist base - 1 (15).

``decode_blocks_indexed_lut`` scans with kernel P3 at K = 6 tokens a step
for 26 steps (``kernels/inflate_scan.py``), then expands and resolves
(``kernels/inflate.py::_expand_and_resolve``). The reference's 12-word row
view and its where-tree column select (``_mux12``) were TPU workarounds
for a per-lane gather; P3 reads its lane's bits directly.
"""

from __future__ import annotations

import functools

import torch

from .inflate import _decode_with_luts
from .inflate_dyn import _canon_tables
from .tables import on_device

LUT_BITS = 12
K = 6        # token slots a step
RSTEPS = 26  # >= ceil(128 / 5): five 48-bit tokens fit a step from any phase
R = K * RSTEPS  # record slots a lane


@functools.lru_cache(maxsize=None)
def _window_codes(nbits: int, device: torch.device) -> torch.Tensor:
    """(2^nbits, nbits) int64: for each LSB-first window, the code value
    its first l bits spell, l = 1..nbits (the window reversed, shifted).
    Made once per device; callers must not write to it."""
    v = torch.arange(1 << nbits, device=device)
    rev = torch.zeros_like(v)
    for i in range(nbits):
        rev = rev | (((v >> i) & 1) << (nbits - 1 - i))
    ls = torch.arange(1, nbits + 1, device=device)
    return rev[:, None] >> (nbits - ls)[None, :]


def _lut_decode_all(lengths: torch.Tensor, A: int, nbits: int = LUT_BITS):
    """Decode every ``nbits``-bit window against each block's code.
    ``lengths`` (B, A); returns (sym, clen, ok), each (B, 2^nbits). A window
    whose code is longer than ``nbits`` (or absent) has ok False."""
    count, first, base, symlist = _canon_tables(lengths, A)
    cand = _window_codes(nbits, lengths.device)                        # (2^nbits, nbits)
    rows = torch.arange(1 << nbits, device=lengths.device)
    fst, cnt = first[:, None, :nbits], count[:, None, :nbits]
    okl = (cand[None] >= fst) & (cand[None] < fst + cnt)                # (B, 2^nbits, nbits)
    l_idx = torch.argmax(okl.to(torch.uint8), dim=2)                   # the first length that fits
    any_ok = okl.any(2)
    off = (base.gather(1, l_idx) + cand[rows[None], l_idx]
           - first.gather(1, l_idx))
    sym = symlist.gather(1, torch.clamp(off, 0, A - 1))
    return sym, l_idx + 1, any_ok


def _lit_lut_block(lit_lens: torch.Tensor, nbits: int = LUT_BITS) -> torch.Tensor:
    """(B, 2^nbits) int32 packed lit/len records from (B, 288) lengths."""
    sym, clen, ok = _lut_decode_all(lit_lens.to(torch.int64), 288, nbits)
    dev = lit_lens.device
    is_lit = ok & (sym < 256)
    is_eob = ok & (sym == 256)
    is_match = ok & (sym > 256) & (sym < 286)
    code = torch.clamp(sym - 257, 0, 28)
    kind = torch.where(is_lit, 0, torch.where(is_match, 1, torch.where(is_eob, 2, 3)))
    arg = torch.where(is_lit, sym, on_device("length_base", dev)[code] - 3)
    lxb = torch.where(is_match, on_device("length_extra", dev)[code], 0)
    return (kind | (torch.clamp(clen, 1, 15) << 2) | (lxb << 6)
            | (torch.clamp(arg, 0, 255) << 9)).to(torch.int32)


def _dist_lut_block(dist_lens: torch.Tensor, nbits: int = LUT_BITS) -> torch.Tensor:
    """(B, 2^nbits) int32 packed distance records from (B, 30) lengths."""
    sym, clen, ok = _lut_decode_all(dist_lens.to(torch.int64), 30, nbits)
    dev = dist_lens.device
    valid = ok & (sym < 30)
    s = torch.clamp(sym, 0, 29)
    return (valid.to(torch.int64) | (torch.clamp(clen, 1, 15) << 1)
            | (on_device("dist_extra", dev)[s] << 5)
            | ((on_device("dist_base", dev)[s] - 1) << 9)).to(torch.int32)


def decode_blocks_indexed_lut(comps: torch.Tensor, seg_bits: torch.Tensor, ns: torch.Tensor,
                              lit_lens: torch.Tensor, dist_lens: torch.Tensor, *,
                              n_out: int):
    """Decode a batch of indexed deflate blocks whose codes are at most 12
    bits (every stream the block encode writes); 13-15-bit codes take
    :func:`inflate_dyn.decode_blocks_indexed_dyn`.

    ``comps`` uint8 (B, CAP), CAP a multiple of 16, each row a block's bytes
    and at least 12 zero bytes; ``seg_bits`` int32 (B, n_out / 128);
    ``ns`` int32 (B,); ``lit_lens`` (B, 288) and ``dist_lens`` (B, 30) code
    lengths. Returns (out u8[B*n_out], ok i32[1]); only each block's first
    ``ns[b]`` bytes of ``out`` are defined."""
    return _decode_with_luts(comps, seg_bits, ns, _lit_lut_block(lit_lens),
                             _dist_lut_block(dist_lens), K, RSTEPS, n_out)
