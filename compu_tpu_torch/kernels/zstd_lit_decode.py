"""The zstd 4-stream Huffman literal decode on the device (RFC 8878
§3.1.1.3.1), kernel P2.

Port of ``compu_tpu/kernels/zstd_lit_decode_jax.py`` (``_decode_lanes``,
``decode_4stream_device``). A 4-stream literal section holds four
independent backward bitstreams, decoded as four lanes. A step of a lane
reads its next ``max_bits`` stream bits (a 3-byte window), looks up
(symbol, nbits) in the section's flat table, writes one byte and retires
nbits: the semantics of ``HufTable.decode_stream``, lane by lane.

The reference ran the steps as one ``jax.lax.fori_loop``. Here
``huf_decode_lanes`` runs them as one CUDA kernel launch
(``csrc/huf_lit_decode.cu``) for CUDA tensors, and as a Python loop over
tensors, ``huf_decode_lanes_torch``, for CPU tensors.

A malformed stream is not decoded again on the host, as the reference
does: ``decode_4stream_device`` raises the error the reference's host
re-decode raises, from the per-lane flags.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.base import CodecFailure
from ..formats.zstd.fse import ERR_FSE
from ..formats.zstd.huff import ERR_HUF, MAX_BITS

TABLE = 1 << MAX_BITS  # table entries per section, the largest 2^max_bits


def _check_lanes(streams, bits0, counts, symbol, nbits, max_bits, max_steps: int):
    """Validate the arguments' shapes; returns (L, S)."""
    if streams.dim() != 2 or streams.shape[0] < 1 or not 8 <= streams.shape[1] < 1 << 28:
        raise ValueError(f"streams must be (L >= 1, 8 <= scap < 2^28), "
                         f"got {tuple(streams.shape)}")
    L = streams.shape[0]
    S = max_bits.shape[0] if max_bits.dim() == 1 else -1
    if S < 1 or L % S:
        raise ValueError(f"max_bits must be (S,) with S dividing L = {L}, "
                         f"got {tuple(max_bits.shape)}")
    for name, t, shape in (("bits0", bits0, (L,)), ("counts", counts, (L,)),
                           ("symbol", symbol, (S, TABLE)), ("nbits", nbits, (S, TABLE))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not 1 <= max_steps < 1 << 31:
        raise ValueError(f"max_steps must be in [1, 2^31), got {max_steps}")
    return L, S


def huf_decode_lanes_torch(streams, bits0, counts, symbol, nbits, max_bits,
                           max_steps: int):
    """Plain version: one loop iteration a step, vectorised over lanes.

    ``streams`` (L, scap) uint8, each lane's backward stream zero-padded;
    ``bits0`` (L,) int32, its bit count without the sentinel; ``counts``
    (L,) int32, its symbols; ``symbol`` and ``nbits`` (S, 2048) uint8, the
    flat table of each of S sections (2^max_bits entries used), lane i in
    section i // (L / S); ``max_bits`` (S,) int32. A lane takes
    min(count, max_steps) steps. Returns ``out`` (L, max_steps) uint8 (0
    past a lane's count), and two flags (L,) bool: ``ok``, the device rule
    (no empty cell met, the counter at -64 bits or above), and
    ``host_ok``, the host rule of ``HufTable.decode_stream`` (no empty
    cell, the counter at -32 or above)."""
    L, S = _check_lanes(streams, bits0, counts, symbol, nbits, max_bits, max_steps)
    dev = streams.device
    scap = streams.shape[1]
    sec = torch.arange(L, device=dev) // (L // S)
    m = max_bits.to(torch.int64)[sec]
    mask = (1 << m) - 1
    sym_t = symbol.to(torch.int64)[sec]
    nb_t = nbits.to(torch.int64)[sec]
    s = streams.to(torch.int64)
    cnt = counts.to(torch.int64)
    bits = bits0.to(torch.int64)
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    out = torch.zeros(L, max_steps, dtype=torch.uint8, device=dev)
    for k in range(min(max_steps, max(int(cnt.max()), 0))):
        active = k < cnt
        idx_pos = bits - m
        j = torch.clamp(torch.clamp(idx_pos, min=0) >> 3, max=scap - 3)
        w = (s.gather(1, j[:, None]) | (s.gather(1, j[:, None] + 1) << 8)
             | (s.gather(1, j[:, None] + 2) << 16))[:, 0]
        # The window's shift stays below 32, as the kernel's 32-bit one
        # must: past 24 it gives 0 either way.
        shift = torch.clamp(torch.clamp(idx_pos, min=0) - (j << 3), max=31)
        idx = torch.where(idx_pos >= 0, (w >> shift) & mask,
                          (w << torch.clamp(-idx_pos, 0, 16)) & mask)
        nb = nb_t.gather(1, idx[:, None])[:, 0]
        out[:, k] = torch.where(active, sym_t.gather(1, idx[:, None])[:, 0], 0).to(torch.uint8)
        bad |= active & (nb == 0)
        bits = torch.where(active, bits - nb, bits)
    return out, ~bad & (bits >= -64), ~bad & (bits >= -32)


def huf_decode_lanes_cuda(streams, bits0, counts, symbol, nbits, max_bits,
                          max_steps: int):
    """The CUDA kernel (``csrc/huf_lit_decode.cu``); same contract as
    :func:`huf_decode_lanes_torch`, for ``max_bits`` in 0..11. The kernel
    reads each row as aligned 32-bit words: a row whose length is not a
    multiple of 4 (or a misaligned tensor) is copied into rows padded with
    zero bytes first, which decode the same (``lane_inputs`` makes rows
    that need no copy)."""
    from .. import _build

    _build.require(streams, "streams", ndim=2, dtype=torch.uint8)
    for name, t, ndim, dtype in (("bits0", bits0, 1, torch.int32),
                                 ("counts", counts, 1, torch.int32),
                                 ("symbol", symbol, 2, torch.uint8),
                                 ("nbits", nbits, 2, torch.uint8),
                                 ("max_bits", max_bits, 1, torch.int32)):
        _build.require(t, name, ndim=ndim, dtype=dtype)
        if t.device != streams.device:
            raise ValueError(f"{name} must be on {streams.device}")
    L, S = _check_lanes(streams, bits0, counts, symbol, nbits, max_bits, max_steps)
    scap = streams.shape[1]
    if scap % 4 or streams.data_ptr() % 4:
        padded = torch.zeros(L, -(-scap // 4) * 4, dtype=torch.uint8, device=streams.device)
        padded[:, :scap] = streams
        streams = padded
    out = torch.empty(L, max_steps, dtype=torch.uint8, device=streams.device)
    ok = torch.empty(L, dtype=torch.bool, device=streams.device)
    host_ok = torch.empty_like(ok)
    err = _build.lib().compu_huf_decode_lanes(
        streams.data_ptr(), streams.shape[1], bits0.data_ptr(), counts.data_ptr(),
        symbol.data_ptr(), nbits.data_ptr(), max_bits.data_ptr(), L // S, S,
        out.data_ptr(), max_steps, ok.data_ptr(), host_ok.data_ptr(),
        _build.stream_handle(streams))
    _build.check_launch(err, "huf_decode_lanes")
    return out, ok, host_ok


def huf_decode_lanes(streams, bits0, counts, symbol, nbits, max_bits, max_steps: int):
    """The lane decode: the kernel on CUDA, the plain version on the CPU."""
    kind = streams.device.type
    if kind == "cuda":
        return huf_decode_lanes_cuda(streams, bits0, counts, symbol, nbits, max_bits,
                                     max_steps)
    if kind == "cpu":
        return huf_decode_lanes_torch(streams, bits0, counts, symbol, nbits, max_bits,
                                      max_steps)
    raise ValueError(f"no huf_decode_lanes for device {streams.device}")


def lane_inputs(bodies: list[bytes], counts: list[int], symbol: np.ndarray,
                nbits: np.ndarray, max_bits: int, device):
    """One section's lanes as tensors on ``device``: ``streams`` (L, scap)
    with scap = max(8, longest body + 3) rounded up to a multiple of 4 (the
    kernel reads rows as 32-bit words), ``bits0``, ``counts``, ``symbol``
    and ``nbits`` (1, 2048), ``max_bits`` (1,). A body without a sentinel
    (empty, or ending in a zero byte) gets 0 bits and 0 symbols. Also
    returns the per-lane sentinel flags, and ``max_steps``, the largest
    count."""
    L = len(bodies)
    scap = -(-max(8, max(len(b) for b in bodies) + 3) // 4) * 4
    streams = np.zeros((L, scap), np.uint8)
    ints = np.zeros(2 * L + 1, np.int32)  # bits0, counts, max_bits
    sentinel = [len(b) > 0 and b[-1] != 0 for b in bodies]
    for i, b in enumerate(bodies):
        streams[i, : len(b)] = np.frombuffer(b, np.uint8)
        if sentinel[i]:
            ints[i] = (len(b) - 1) * 8 + int(b[-1]).bit_length() - 1
            ints[L + i] = counts[i]
    ints[2 * L] = max_bits
    tab = np.zeros((2, 1, TABLE), np.uint8)
    tab[0, 0, : len(symbol)] = symbol
    tab[1, 0, : len(nbits)] = nbits
    ints_d = torch.from_numpy(ints).to(device)
    tab_d = torch.from_numpy(tab).to(device)
    args = (torch.from_numpy(streams).to(device), ints_d[:L], ints_d[L:2 * L],
            tab_d[0], tab_d[1], ints_d[2 * L:])
    return args, sentinel, max(max(counts), 1)


def decode_4stream_device(bodies: list[bytes], counts: list[int], symbol: np.ndarray,
                          nbits: np.ndarray, max_bits: int, device) -> bytes:
    """Decode one section's streams (``counts`` symbols each, every count
    above 0) on ``device`` with kernel P2 (its plain version on the CPU);
    returns the literals. ``symbol``/``nbits`` are HufTable's flat
    2^max_bits arrays.

    The reference decodes on its device and, when a lane is malformed
    (no sentinel, an empty cell, a counter below -64 bits), decodes the
    section again on the host, which raises for the first stream in order
    that fails there. Here no stream is decoded twice: when every lane has
    a sentinel and is ``ok`` the literals are taken, as the reference
    takes its device's; else the first stream in order without a sentinel
    raises ``ERR_FSE`` and the first that fails the host rule ``ERR_HUF``,
    whichever comes first."""
    args, sentinel, max_steps = lane_inputs(bodies, counts, symbol, nbits, max_bits,
                                            device)
    out, ok, host_ok = huf_decode_lanes(*args, max_steps)
    flags = torch.stack([ok, host_ok]).cpu().numpy()
    if not (all(sentinel) and flags[0].all()):
        for i in range(len(bodies)):
            if not sentinel[i]:
                raise CodecFailure(ERR_FSE, "corrupt bitstream (no sentinel)")
            if not flags[1, i]:
                raise CodecFailure(ERR_HUF, "corrupt huffman stream")
        raise AssertionError("a lane failed the device rule but passed the host rule")
    outs = out.cpu().numpy()
    return b"".join(outs[i, : counts[i]].tobytes() for i in range(len(bodies)))
