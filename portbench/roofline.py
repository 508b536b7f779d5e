"""The yardstick of the hand kernels' roofline: the card's peaks, and the
bytes and integer operations each function needs, whatever implements it.

A function's bound is the larger of its memory time (its inputs read
once and its outputs written once, at the card's peak bandwidth) and its
operation time (the integer operations its work needs, at the card's
INT32 issue rate). The byte counts are frozen copies, restricted to
bytes, of the counts the port's smoke run keeps for its kernels
(``lcp_work``, ``parse_work``, ``emit_work`` and ``build_tables_work``),
written here from the batch's shape: ``B`` blocks of ``N`` bytes and the
matcher's window of ``wcap`` bytes. Operations are counted for B1 alone
(:func:`lcp_ops`), from the data: at depth 48 they outweigh its bytes.
The other three's operations are a tenth of their bytes' time or less at
these shapes (the smoke run's counts: B2 15.3 M operations against 37.7
MB, B3 10.8 M against 134 MB, P5 under 0.01 M against 0.2 MB, on 16
blocks), so their bytes bound them.
"""

from __future__ import annotations

import numpy as np

#: Peak device-memory bandwidth in bytes/s by ``torch.cuda.get_device_name``
#: (NVIDIA's H100 data sheet: the SXM part, 80 GB of HBM3 at 3.35 TB/s).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
#: Peak INT32 operations/s: 64 INT32 lanes an SM x 132 SMs x the 1.98 GHz
#: boost clock (NVIDIA's H100 architecture paper).
PEAK_INT_OPS_PER_S = {"NVIDIA H100 80GB HBM3": 64 * 132 * 1.98e9}
#: Operations a weighed candidate needs at least: the running minimum of
#: the common prefix, the length and distance packed into one key, and
#: the maximum with the best so far.
OPS_PER_CANDIDATE = 3

SEG = 128          # bytes a segment of the cover and of the packed rows
ROW_BYTES = 512    # a packed segment row, in int32 words: W2 of the emit
NLIT, NDIST, NHDR = 286, 30, 336


def lcp_candidates(B: int, N: int, wcap: int) -> int:
    """B1: per lane, its ``wcap / 4`` window words and its position in
    (int32), its best length and distance out (int32)."""
    return B * N * (4 * (wcap // 4) + 4 + 8)


def lcp_ops(blocks, wcap: int, depth: int) -> int:
    """B1's operations over the blocks of a request, each a (N,) uint8
    array: ``OPS_PER_CANDIDATE`` for each candidate weighed, and 3 a window
    word a lane for the common prefix with its neighbour (exclusive or,
    leading zeros, accumulate).

    A lane weighs, in each direction of the sort order, the candidates up
    to and including the first whose common prefix with it is 0. The sort
    puts windows with the same first byte together, and two windows share
    a prefix exactly where their first bytes agree, so a lane at rank r
    of the c lanes of its first byte weighs 1 + min(depth - 1, r)
    candidates back and 1 + min(depth - 1, c - 1 - r) forward: over a
    group, 2c + 2 S(c), S(c) the sum of min(depth - 1, r) for r < c."""
    total = 0
    for block in blocks:
        c = np.bincount(np.asarray(block, np.uint8), minlength=256).astype(np.int64)
        d1 = depth - 1
        s = np.where(c <= depth, c * (c - 1) // 2, d1 * depth // 2 + (c - depth) * d1)
        total += int((2 * c + 2 * s).sum()) * OPS_PER_CANDIDATE + 3 * (wcap // 4) * len(block)
    return total


def parse_cover(B: int, N: int, wcap: int) -> int:
    """B2: the int64 step array in, the bool cover out."""
    return B * N * (8 + 1)


def emit_pack(B: int, N: int, wcap: int) -> int:
    """B3: a segment's 2 x 128 int32 byte positions and bit patterns in,
    its packed row of 512 int32 out."""
    return (B * N // SEG) * (2 * 2 * SEG * 4 + ROW_BYTES * 4)


def build_tables(B: int, N: int, wcap: int) -> int:
    """P5: per block the int64 lit/len and distance histograms, two extra
    bit counts and the length in; the lengths and codes of both trees, the
    header's values and bit counts, its total (int64) and the stored flag
    (bool) out."""
    return B * (8 * (NLIT + NDIST + 3) + 8 * (2 * NLIT + 2 * NDIST + 2 * NHDR + 1) + 1)


#: The kernel names the trace shows for each function.
KERNELS = {"lcp_kernel": lcp_candidates, "parse_cover_kernel": parse_cover,
           "emit_pack_kernel": emit_pack, "build_tables_kernel": build_tables}


def request_bound_s(data: bytes, N: int, matcher: dict, kind: str) -> float | None:
    """The four functions' bound in seconds on one request's batch: the
    input cut into blocks of ``N`` bytes (the last padded with zeros, as
    the batch is), each function at the larger of its bytes' and its
    operations' time. None for a card with no peaks here."""
    bw, ops = PEAK_BYTES_PER_S.get(kind), PEAK_INT_OPS_PER_S.get(kind)
    if bw is None or ops is None:
        return None
    B, wcap = -(-len(data) // N), int(matcher["wcap"])
    raw = np.zeros(B * N, np.uint8)
    raw[:len(data)] = np.frombuffer(data, np.uint8)
    blocks = raw.reshape(B, N)
    bound = max(lcp_candidates(B, N, wcap) / bw, lcp_ops(blocks, wcap, int(matcher["depth"])) / ops)
    return bound + sum(f(B, N, wcap) / bw for k, f in KERNELS.items() if k != "lcp_kernel")
