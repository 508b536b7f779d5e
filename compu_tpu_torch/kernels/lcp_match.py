"""Lexicographic-sort LCP matcher: the LZ candidate stage.

Port of ``compu_tpu/kernels/lcp_match.py``. Positions sort by their
wcap-byte window (big-endian words); ``adj[i]`` counts the equal leading
bytes of sorted neighbours i-1 and i; the LCP to any sorted neighbour i±d is
a running min of ``adj``, at distance ``ps[i] - ps[i±d]``. Both sort-order
directions are scanned up to ``depth``; the best (len, dist) with
0 < dist <= max_dist wins, the nearer distance on equal length (the
farther with ``prefer_far``, the reference's ``COMPU_LCP_TIE=far``).

Layout: flat sorted arrays over the whole batch, ``block_elems`` lanes per
block; neighbours never cross a block (``adj`` is 0 at every block start).

``lcp_candidates`` dispatches by device: the CUDA kernel
(``csrc/lcp_candidates.cu``) for a CUDA tensor, the plain twin
``lcp_candidates_torch`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import u32

HALO = 128  # the kernel's depth limit, as the reference's
MAX_DIST_CUDA = 1 << 24  # the kernel packs (max_dist - dist) into 24 bits


def swap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap u32 values (int64) so integer order == lexicographic byte
    order."""
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))


def sort_stage_lex(datas: torch.Tensor, *, wcap: int, keys: int = 2,
                   stride: int = 1) -> list[torch.Tensor]:
    """Per-block lexicographic sort of the window words.

    ``datas`` (B, N) uint8 -> ``[w0be, ..., ps]``, each (B, N/stride) int64:
    the wcap/4 big-endian window words and the position, in sort order. The
    first ``keys`` words are the sort key, the others ride as payload.
    ``lax.sort(num_keys=k, is_stable=True)`` becomes one stable sort of an
    order-preserving int64 key: ``w0`` for one key word, ``(w0 << 32 | w1)``
    with the sign bit flipped for two. Tail windows wrap to the block's
    front, as ``jnp.roll`` does."""
    from .deflate_v2 import _u32_words

    B, N = datas.shape
    pos = torch.arange(N, device=datas.device, dtype=torch.int64).expand(B, N)
    words = [swap32(_u32_words(datas, k)) for k in range(wcap // 4)]
    if stride == 2:
        pos = pos[:, ::2]
        words = [w[:, ::2] for w in words]
    elif stride != 1:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    keys = min(keys, len(words))
    if keys == 1:
        key = words[0]
    elif keys == 2:
        key = ((words[0] << 32) | words[1]) ^ torch.iinfo(torch.int64).min
    else:
        raise ValueError(f"keys must be 1 or 2, got {keys}")
    _, order = torch.sort(key, dim=-1, stable=True)
    return [w.gather(-1, order) for w in words] + [pos.gather(-1, order)]


def _lzb(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bytes (0..4) of u32 values held in int64."""
    return ((x <= 0xFFFFFF).to(torch.int64) + (x <= 0xFFFF) + (x <= 0xFF)
            + (x == 0))


def _adj_from_words(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Matched leading bytes between two (W, n) word stacks."""
    l = _lzb(cur[0] ^ prev[0])
    for k in range(1, cur.shape[0]):
        lk = _lzb(cur[k] ^ prev[k])
        l = l + torch.where(l == 4 * k, lk, 0)
    return l


def _check_args(depth: int, block_elems: int, n: int) -> None:
    if not 1 <= depth < HALO:
        raise ValueError(f"depth must be in [1, {HALO}), got {depth}")
    check_blocks(block_elems, n)


def check_blocks(block_elems: int, n: int) -> None:
    """Raise unless ``n`` flat lanes are whole blocks of a power of two."""
    if block_elems <= 0 or block_elems & (block_elems - 1):
        raise ValueError(f"block_elems must be a power of two, got {block_elems}")
    if n % block_elems:
        raise ValueError(f"{n} lanes are not whole blocks of {block_elems}")


def lcp_candidates_torch(words: torch.Tensor, ps: torch.Tensor, *, depth: int,
                         max_dist: int, block_elems: int, prefer_far: bool = False):
    """Plain twin of the kernel (and port of ``lcp_candidates_xla``).

    ``words`` (W, n) int32 u32 bit patterns in sort order, ``ps`` (n,) int32
    -> (best_len, best_dist), each (n,) int32. An equal length keeps the
    nearer distance, or with ``prefer_far`` the farther one."""
    n = ps.shape[0]
    _check_args(depth, block_elems, n)
    w = u32.from_i32_bits(words)
    ps = ps.to(torch.int64)
    lpos = torch.arange(n, device=ps.device, dtype=torch.int64) & (block_elems - 1)
    adj = _adj_from_words(w, torch.roll(w, 1, dims=1))
    adj = torch.where(lpos == 0, 0, adj)

    best_len = torch.zeros_like(ps)
    best_dist = torch.zeros_like(ps)

    def upd(best_len, best_dist, l, dist):
        valid = (dist > 0) & (dist <= max_dist) & (l > 0)
        tie = (l == best_len) & ((dist > best_dist) if prefer_far else (dist < best_dist))
        better = valid & ((l > best_len) | tie)
        return (torch.where(better, l, best_len),
                torch.where(better, dist, best_dist))

    mb = adj
    mf = torch.where(lpos == block_elems - 1, 0, torch.roll(adj, -1))
    for d in range(1, depth + 1):
        best_len, best_dist = upd(best_len, best_dist, mb, ps - torch.roll(ps, d))
        best_len, best_dist = upd(best_len, best_dist, mf, ps - torch.roll(ps, -d))
        if d < depth:
            mb = torch.minimum(mb, torch.roll(adj, d))
            nxt = torch.where(lpos >= block_elems - (d + 1), 0,
                              torch.roll(adj, -(d + 1)))
            mf = torch.minimum(mf, nxt)
    return best_len.to(torch.int32), best_dist.to(torch.int32)


def lcp_candidates_cuda(words: torch.Tensor, ps: torch.Tensor, *, depth: int,
                        max_dist: int, block_elems: int, prefer_far: bool = False):
    """The CUDA kernel (``csrc/lcp_candidates.cu``); same contract as
    :func:`lcp_candidates_torch`, for ``0 <= max_dist <= 2^24`` (the kernel
    packs a distance into 24 bits)."""
    from .. import _build

    _build.require(words, "words", ndim=2)
    _build.require(ps, "ps", ndim=1)
    W, n = words.shape
    if ps.shape[0] != n or ps.device != words.device:
        raise ValueError("ps must match words' lane count and device")
    if not 1 <= W <= 8:
        raise ValueError(f"1..8 window words supported, got {W}")
    if not 0 <= max_dist <= MAX_DIST_CUDA:
        raise ValueError(f"max_dist must be in [0, {MAX_DIST_CUDA}], got {max_dist}")
    _check_args(depth, block_elems, n)
    best_len = torch.empty(n, dtype=torch.int32, device=ps.device)
    best_dist = torch.empty_like(best_len)
    if n == 0:
        return best_len, best_dist
    err = _build.lib().compu_lcp_candidates(
        words.data_ptr(), W, ps.data_ptr(), best_len.data_ptr(),
        best_dist.data_ptr(), n, block_elems, depth, max_dist, int(prefer_far),
        _build.stream_handle(ps))
    _build.check_launch(err, "lcp_candidates")
    return best_len, best_dist


def lcp_candidates(words: torch.Tensor, ps: torch.Tensor, *, depth: int,
                   max_dist: int, block_elems: int, prefer_far: bool = False):
    """Best (len, dist) per sorted lane: the kernel on CUDA, the twin on
    the CPU."""
    kind = ps.device.type
    if kind == "cuda":
        fn = lcp_candidates_cuda
    elif kind == "cpu":
        fn = lcp_candidates_torch
    else:
        raise ValueError(f"no lcp_candidates for device {ps.device}")
    return fn(words, ps, depth=depth, max_dist=max_dist, block_elems=block_elems,
              prefer_far=prefer_far)
