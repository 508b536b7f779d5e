"""Exact greedy token cover, segment by segment.

Port of ``parse_pallas.parse_cover_pallas`` and its XLA form
``deflate_jax_v2.parse_cover_mxu``: (N,) advances -> (N,) bool.
``step[i]`` is the greedy parser's advance at position i, clipped so that
no step crosses a 128-position segment. Within each segment,
``nl[i] = min(i + max(step[i], 1), 128)``; the cover is the orbit of local
0 under ``i -> nl[i]``.

The TPU squares a one-hot jump matrix 7 times. The plain version here
(:func:`jump_targets`, then :func:`parse_cover_torch`) computes the same 7
rounds by gather doubling instead (the one-hot products would be ~60 GFLOP
per 256 KiB block on a CPU). The CUDA kernel (``csrc/parse_cover.cu``)
computes the whole function in one launch, from the int64 steps to the
bool mask: four positions a lane, a walk of each lane's window in
registers, four doubling rounds over the windows' jumps, and each lane
stepping to one state of the orbit; :func:`parse_cover_lanes_torch`
models its lanes on the CPU.
"""

from __future__ import annotations

import torch

SEG = 128
LANES = 32  # the kernel's lanes a segment, each a window of 4 positions
LEVELS = 5  # the kernel's jump tables J_0..J_4: 1, 2, 4, 8 and 16 windows


def jump_targets(step: torch.Tensor) -> torch.Tensor:
    """(N,) advances -> (N/128, 128) int32 segment-local jump targets."""
    N = step.shape[0]
    local = torch.arange(N, device=step.device, dtype=torch.int64) & (SEG - 1)
    nl = torch.clamp(local + torch.clamp(step.to(torch.int64), 1, SEG), max=SEG)
    return nl.reshape(N // SEG, SEG).to(torch.int32)


def parse_cover_torch(nl: torch.Tensor) -> torch.Tensor:
    """Plain twin of the cover: (S, seg) int32 jump targets -> (S, seg)
    int32 0/1 mask.

    ``reach |= scatter(reach through jump^(2^k))`` for k < log2(seg), with
    column ``seg`` as the sink that absorbs jumps off the segment's end —
    the same reach the reference's matrix squaring gives."""
    S, seg = nl.shape
    jump = torch.cat([nl.to(torch.int64),
                      torch.full((S, 1), seg, dtype=torch.int64, device=nl.device)],
                     dim=1)
    reach = torch.zeros(S, seg + 1, dtype=torch.int64, device=nl.device)
    reach[:, 0] = 1
    iters = (seg - 1).bit_length()  # ceil(log2(seg))
    for it in range(iters):
        hop = torch.zeros_like(reach).scatter_add_(1, jump, reach)
        reach = torch.clamp(reach + hop, max=1)
        if it + 1 < iters:
            jump = jump.gather(1, jump)
    return reach[:, :seg].to(torch.int32)


def parse_cover_steps_torch(step: torch.Tensor) -> torch.Tensor:
    """Plain version of the whole function: (N,) advances -> (N,) bool."""
    return parse_cover_torch(jump_targets(step)).reshape(-1) > 0


def _byte(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> (8 * k)) & 0xFF


def parse_cover_lanes_torch(step: torch.Tensor) -> torch.Tensor:
    """CPU model of the CUDA kernel, lane by lane: (N,) advances -> (N,)
    bool, with the kernel's data layout and arithmetic (``csrc/
    parse_cover.cu``, steps 1-5), all segments and lanes at once."""
    S = step.shape[0] // SEG
    dev = step.device
    lane = torch.arange(LANES, device=dev, dtype=torch.int64)
    base = 4 * lane
    shift = 8 * torch.arange(4, device=dev, dtype=torch.int64)
    # 1. Lane j loads positions 2j, 2j+1, 64+2j, 65+2j and packs their
    # clamped steps; lane l takes its window's from lanes 2l, 2l+1 mod 32.
    held = torch.clamp(step.to(torch.int64).reshape(S, 2, LANES, 2), 1, SEG)
    held = (held.permute(0, 2, 1, 3).reshape(S, LANES, 4) << shift).sum(-1)
    a, b = held[:, (2 * lane) % LANES], held[:, (2 * lane + 1) % LANES]
    low = lane < 16
    t = sum(torch.where(low, _byte(src, k), _byte(src, k + 2)) << (8 * o)
            for o, (src, k) in enumerate(((a, 0), (a, 1), (b, 0), (b, 1))))
    t = t + base * 0x01010101 + 0x03020100
    t = t & ~(((t >> 7) & 0x01010101) * 0x7F)
    # 2. The walk of each window from each entry offset o: its exit X[o] and
    # the window positions it marks, a nibble M[o].
    X, M = [None] * 4, [None] * 4
    for o in (3, 2, 1, 0):
        X[o] = _byte(t, o)
        M[o] = torch.full_like(t, 1 << o)
        for q in range(o + 1, 4):
            hit = _byte(t, o) == base + q
            X[o] = torch.where(hit, X[q], X[o])
            M[o] = torch.where(hit, M[o] | M[q], M[o])
    marks = M[0] | M[1] << 4 | M[2] << 8 | M[3] << 12
    # 3. J_0..J_4 as (S, 129) tables, the sink at 128.
    sink = torch.full((S, 1), SEG, dtype=torch.int64, device=dev)
    J = list(X)
    tables = [torch.cat([torch.stack(J, -1).reshape(S, SEG), sink], 1)]
    for k in range(LEVELS - 1):
        J = [tables[k].gather(1, j) for j in J]
        tables.append(torch.cat([torch.stack(J, -1).reshape(S, SEG), sink], 1))
    # 4. Lane l takes the orbit's state number l, J^l(0), one bit of l a
    # level, and writes its offset as its window's entry; a window no state
    # falls in keeps 4. States past the orbit's end (128) write entry[32].
    s = torch.zeros(S, LANES, dtype=torch.int64, device=dev)
    for k in range(LEVELS):
        s = torch.where((lane >> k) & 1 == 1, tables[k].gather(1, s), s)
    entry = torch.full((S, LANES + 1), 4, dtype=torch.int64, device=dev)
    e = entry.scatter_(1, s >> 2, s & 3)[:, :LANES]
    # 5. The entry's nibble, one 0/1 byte a position.
    word = (((marks >> (4 * e)) & 0xF) * 0x00204081) & 0x01010101
    return (_byte(word[..., None], torch.arange(4, device=dev)) != 0).reshape(-1)


def parse_cover_cuda(step: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/parse_cover.cu``), one launch: a contiguous,
    16-byte aligned (N,) int64 CUDA tensor of advances, N a multiple of
    128 -> (N,) bool. Same function as :func:`parse_cover_steps_torch`."""
    from .. import _build

    if not isinstance(step, torch.Tensor):
        raise TypeError(f"step: expected a tensor, got {type(step).__name__}")
    if step.dtype != torch.int64:
        raise TypeError(f"step: expected torch.int64, got {step.dtype}")
    if step.dim() != 1 or step.shape[0] % SEG:
        raise ValueError(f"step: expected (N,) with N a multiple of {SEG}, "
                         f"got shape {tuple(step.shape)}")
    _build.require(step, "step", ndim=1, dtype=torch.int64)
    if step.data_ptr() % 16:
        raise ValueError("step: expected a 16-byte aligned tensor")
    out = torch.empty(step.shape[0], dtype=torch.bool, device=step.device)
    if step.shape[0] == 0:
        return out
    err = _build.lib().compu_parse_cover(step.data_ptr(), out.data_ptr(),
                                         step.shape[0] // SEG, _build.stream_handle(step))
    _build.check_launch(err, "parse_cover")
    return out


def parse_cover(step: torch.Tensor) -> torch.Tensor:
    """Greedy cover over a flat (possibly multi-block) step array: (N,)
    advances -> (N,) bool; the kernel on CUDA, the plain version on the
    CPU. Segments never cross blocks, so blocks concatenate freely."""
    kind = step.device.type
    if kind == "cuda":
        return parse_cover_cuda(step)
    if kind == "cpu":
        return parse_cover_steps_torch(step)
    raise ValueError(f"no parse_cover for device {step.device}")
