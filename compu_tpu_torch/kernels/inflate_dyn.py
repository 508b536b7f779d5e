"""The dyn route of the indexed DEFLATE inflate, and the host parse of a
block's header.

Port of ``compu_tpu/kernels/inflate_jax_dyn.py``. ``parse_block_tables``
reads one deflate block header on the host into 288 lit/len and 30
distance code lengths; ``_canon_tables`` turns lengths into canonical
decode tables (RFC1951 §3.2.2), batched over blocks.
``decode_blocks_indexed_dyn`` decodes blocks with codes of any length up
to 15 bits: the reference's canonical arithmetic over a 15-bit window,
one token a lane a step for up to 128 steps, becomes direct lookup tables
over every 15-bit window (the same arithmetic, evaluated once per entry on
the device) and the one scan of kernel P3 at K = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.deflate import consts
from ..ops.bitio import BitReader
from ..ops.huffman import build_decode_table
from .inflate import _decode_with_luts
from .inflate_scan import SEG

MAXB = 15  # RFC1951 max code length


def _canon_tables(lengths: torch.Tensor, A: int):
    """Canonical decode tables of each block's code: ``lengths`` (B, A)
    -> (count, first, base) (B, 15) each and ``symlist`` (B, A), the
    symbols by (length, symbol) with unused ones last."""
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    ls = torch.arange(1, MAXB + 1, device=dev)
    count = (lengths[:, :, None] == ls).sum(1)
    first = torch.zeros_like(count)
    code = torch.zeros_like(count[:, 0])
    for i in range(1, MAXB):
        code = (code + count[:, i - 1]) << 1
        first[:, i] = code
    base = torch.cumsum(count, 1) - count
    key = torch.where(lengths > 0, lengths, 99) * (2 * A) + torch.arange(A, device=dev)
    symlist = torch.argsort(key, dim=1)
    return count, first, base, symlist


def decode_blocks_indexed_dyn(comps: torch.Tensor, seg_bits: torch.Tensor, ns: torch.Tensor,
                              lit_lens: torch.Tensor, dist_lens: torch.Tensor, *,
                              n_out: int):
    """Decode a batch of indexed deflate blocks with per-block codes of up
    to 15 bits. Arguments and result as
    :func:`inflate_lut.decode_blocks_indexed_lut`."""
    from .inflate_lut import _dist_lut_block, _lit_lut_block   # inflate_lut imports this module

    return _decode_with_luts(comps, seg_bits, ns, _lit_lut_block(lit_lens, MAXB),
                             _dist_lut_block(dist_lens, MAXB), 1, SEG, n_out)


def parse_block_tables(blob: bytes):
    """Parse ONE deflate block header from the start of ``blob``.

    Returns (kind, lit_lens[288], dist_lens[30], header_bits); kind 0 =
    stored (tables empty), 1 = fixed, 2 = dynamic. The 288 lengths include
    the two phantom fixed-tree symbols 286 and 287: never emitted, their
    8-bit lengths shift the canonical numbering of every 9-bit code."""
    r = BitReader(bytearray(blob), 0)
    r.read(1)  # bfinal (blocks in a parallel stream are never final)
    btype = r.read(2)
    lit = np.zeros(288, dtype=np.int32)
    dist = np.zeros(30, dtype=np.int32)
    if btype == 0:
        return 0, lit, dist, 0
    if btype == 1:
        lit[:] = consts.FIXED_LITLEN_LENGTHS
        dist[:] = consts.FIXED_DIST_LENGTHS
        return 1, lit, dist, 3
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    clen_lengths = np.zeros(19, dtype=np.int64)
    for i in range(hclen):
        clen_lengths[consts.CLEN_ORDER[i]] = r.read(3)
    cl_syms, cl_lens = build_decode_table(clen_lengths, 7)
    lengths = np.zeros(hlit + hdist, dtype=np.int64)
    i = 0
    while i < hlit + hdist:
        idx = r.peek(7)
        sym = int(cl_syms[idx])
        r.skip(int(cl_lens[idx]))
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            rep = 3 + r.read(2)
            lengths[i: i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + r.read(3)
        else:
            i += 11 + r.read(7)
    lit[:hlit] = lengths[:hlit]
    dist[:hdist] = lengths[hlit: hlit + hdist]
    return 2, lit, dist, r.bitpos
