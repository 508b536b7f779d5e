"""Hash-bucket matcher: the LZ candidate stage of ``matcher="hash"``.

Port of ``compu_tpu/kernels/match_pallas.py`` and its XLA form
``deflate_jax_v2._candidates_xla``. Positions sort by the hash of their
first 3 bytes (stably, so a bucket lists its positions in order). For every
sorted lane i and d = 1..depth, lane i-d is a candidate when it has the same
hash, lies in the same block (``lpos >= d``) and is 0 < dist <= max_dist
behind. Its length is the count of equal leading bytes of the two
little-endian windows: trailing zero bytes of the XOR, word by word, adding
word k only while words 0..k-1 matched in full. A later d replaces the best
only on a strictly longer length, so equal lengths keep the nearest lane in
sort order (not, as the lex matcher's, the nearer distance).

Layout as ``lcp_match``: flat sorted arrays over the whole batch,
``block_elems`` lanes per block; ``hs`` and ``ps`` (n,) int32, the window
words (W, n) int32 u32 bit patterns.

``match_candidates`` dispatches by device: the CUDA kernel
(``csrc/match_candidates.cu``) for a CUDA tensor, the plain twin
``match_candidates_torch`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import u32
from .lcp_match import check_blocks

TILE = 512            # lanes per CUDA block (128 threads, 4 lanes each)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
MAX_WORDS = 8         # window words the kernel takes (wcap 32)
# The kernel's template instances: depth x window words, for blocks of at
# least 4 lanes; every other call runs its generic instance. Mirrors the
# switch in csrc/match_candidates.cu.
TEMPLATE_DEPTHS = (4, 6, 8, 12, 16, 24, 32, 48)
TEMPLATE_WORDS = (2, 4, 8)


def _check_args(depth: int, block_elems: int, n: int) -> None:
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    check_blocks(block_elems, n)


def smem_bytes(nwords: int, depth: int) -> int:
    """Shared memory of one kernel block: hs, ps and the words (at least
    two rows) of a tile and its backward halo of ``depth`` lanes, rounded
    up to 4."""
    return (TILE + 4 * -(-depth // 4)) * (2 + max(nwords, 2)) * 4


def kernel_instance(nwords: int, depth: int, block_elems: int) -> tuple[int, int]:
    """The (depth, nwords) template instance of the kernel a call runs,
    or (0, 0) for the generic instance (run-time depth and word count)."""
    if block_elems >= 4 and depth in TEMPLATE_DEPTHS and nwords in TEMPLATE_WORDS:
        return depth, nwords
    return 0, 0


def _tzb(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bytes (0..4) of u32 values held in int64."""
    return (((x & 0xFF) == 0).to(torch.int64) + ((x & 0xFFFF) == 0)
            + ((x & 0xFFFFFF) == 0) + (x == 0))


def match_candidates_torch(hs: torch.Tensor, ps: torch.Tensor, words: torch.Tensor, *,
                           depth: int, max_dist: int, block_elems: int):
    """Plain twin of the kernel: ``_candidates_xla`` over the flattened
    batch, with the kernel's in-block mask.

    ``hs``, ``ps`` (n,) int32 and ``words`` (W, n) int32 in sort order ->
    (best_len, best_dist), each (n,) int32."""
    n = ps.shape[0]
    _check_args(depth, block_elems, n)
    hs = hs.to(torch.int64)
    ps = ps.to(torch.int64)
    w = u32.from_i32_bits(words)
    lpos = torch.arange(n, device=ps.device, dtype=torch.int64) & (block_elems - 1)
    best_len = torch.zeros_like(ps)
    best_dist = torch.zeros_like(ps)
    for d in range(1, depth + 1):
        dist = ps - torch.roll(ps, d)
        ok = ((hs == torch.roll(hs, d)) & (lpos >= d) & (dist > 0)
              & (dist <= max_dist))
        tz = _tzb(w ^ torch.roll(w, d, dims=1))
        l = tz[0]
        for k in range(1, w.shape[0]):
            l = l + torch.where(l == 4 * k, tz[k], 0)
        l = torch.where(ok, l, 0)
        better = l > best_len
        best_len = torch.where(better, l, best_len)
        best_dist = torch.where(better, dist, best_dist)
    return best_len.to(torch.int32), best_dist.to(torch.int32)


def match_candidates_cuda(hs: torch.Tensor, ps: torch.Tensor, words: torch.Tensor, *,
                          depth: int, max_dist: int, block_elems: int):
    """The CUDA kernel (``csrc/match_candidates.cu``); same contract as
    :func:`match_candidates_torch`, for ``max_dist >= 0`` and positions that
    differ by less than ``2^31 - max_dist`` (distances are 32-bit there).
    Raises where one block's shared memory cannot hold a tile and its
    halo."""
    from .. import _build

    _build.require(hs, "hs", ndim=1)
    _build.require(ps, "ps", ndim=1)
    _build.require(words, "words", ndim=2)
    W, n = words.shape
    if hs.shape[0] != n or ps.shape[0] != n or not hs.device == ps.device == words.device:
        raise ValueError("hs and ps must match words' lane count and device")
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"1..{MAX_WORDS} window words supported, got {W}")
    if max_dist < 0:
        raise ValueError(f"max_dist must be >= 0, got {max_dist}")
    _check_args(depth, block_elems, n)
    need = smem_bytes(W, depth)
    if need > SMEM_LIMIT:
        raise ValueError(f"depth {depth} with {W} words needs {need} bytes of shared "
                         f"memory per block; a block may use at most {SMEM_LIMIT}")
    best_len = torch.empty(n, dtype=torch.int32, device=ps.device)
    best_dist = torch.empty_like(best_len)
    if n == 0:
        return best_len, best_dist
    err = _build.lib().compu_match_candidates(
        hs.data_ptr(), ps.data_ptr(), words.data_ptr(), W, best_len.data_ptr(),
        best_dist.data_ptr(), n, block_elems, depth, max_dist, _build.stream_handle(ps))
    _build.check_launch(err, "match_candidates")
    return best_len, best_dist


def match_candidates(hs: torch.Tensor, ps: torch.Tensor, words: torch.Tensor, *,
                     depth: int, max_dist: int, block_elems: int):
    """Best (len, dist) per hash-sorted lane: the kernel on CUDA, the twin
    on the CPU."""
    kind = ps.device.type
    if kind == "cuda":
        fn = match_candidates_cuda
    elif kind == "cpu":
        fn = match_candidates_torch
    else:
        raise ValueError(f"no match_candidates for device {ps.device}")
    return fn(hs, ps, words, depth=depth, max_dist=max_dist, block_elems=block_elems)
