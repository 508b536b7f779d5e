"""Device block-encode step for the block-parallel scheduler.

Port of ``compu_tpu/kernels/block_codec.py`` (the v3 kernel, and the
fixed-Huffman v2 kernel, ``kernel="v2"``). One upload of
each group's block matrix, the whole encode on the device, compaction of
the padded per-block outputs into one exact-length buffer on the device,
then two fetches: the small metadata, and the compressed bytes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..formats.deflate.options import ZlibMode
from ..ops import checksum
from .deflate_v2 import encode_blocks_fixed_v2
from .deflate_v3 import encode_blocks_dyn

# The depth column of the reference's host ladder (``_LEVEL``, whose nice
# and lazy columns only its unported v1 kernel reads); the v2 kernel
# matches at depth min(depth, 8).
HOST_DEPTH = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 16, 8: 24, 9: 32}

# Device ladder of the lex/LCP matcher, per level.
DEV_WCAP = {1: 8, 2: 8, 3: 8, 4: 16, 5: 16, 6: 16, 7: 16, 8: 16, 9: 16}
DEV_DEPTH = {1: 4, 2: 6, 3: 8, 4: 8, 5: 12, 6: 16, 7: 24, 8: 32, 9: 48}
DEV_KEYS = {1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 6: 2, 7: 2, 8: 2, 9: 2}
DEV_STRIDE = {1: 2, 2: 2, 3: 2, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1, 9: 1}


def _encode_blocks_batched(blocks: torch.Tensor, lens: torch.Tensor, *,
                           depth: int, with_index: bool, check: str,
                           wcap: int = 32, stride: int = 1, lex_keys: int = 2,
                           matcher: str = "lex", kernel: str = "v3"):
    """Encode a (B, N) block matrix and compact it on the device.

    ``kernel`` is ``"v3"`` (dynamic, fixed or stored blocks, the matcher
    as given) or ``"v2"`` (fixed Huffman codes only, the lex matcher at
    its defaults: ``wcap``, ``stride``, ``lex_keys`` and ``matcher`` are
    not read). Returns ``(packed (B*cap + cap,) uint8, metas (B, 2)
    int32, seg_bits (B, S) int32 or None)``; only ``packed[:sum(lens)]``
    is defined: block i's bytes at offset ``sum(lens[:i])``."""
    if kernel == "v2":
        res = encode_blocks_fixed_v2(blocks, lens, depth=depth, with_index=with_index,
                                     check=check)
    elif kernel == "v3":
        res = encode_blocks_dyn(blocks, lens, depth=depth, with_index=with_index,
                                check=check, wcap=wcap, stride=stride,
                                lex_keys=lex_keys, matcher=matcher)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    outs, metas = res[0], res[1]
    B, cap = outs.shape
    out_lens = metas[:, 0].to(torch.int64)
    offsets = torch.cumsum(out_lens, 0) - out_lens
    size = B * cap + cap
    j = torch.arange(cap, device=blocks.device)
    # One masked scatter; bytes past each block's length go to a dump slot.
    dst = torch.where(j < out_lens[:, None], offsets[:, None] + j, size)
    packed = torch.zeros(size + 1, dtype=torch.uint8, device=blocks.device)
    packed.scatter_(0, dst.reshape(-1), outs.reshape(-1))
    return packed[:size], metas, (res[2] if with_index else None)


def make_block_encode_fn(mode: ZlibMode, level: int = 6, kernel: str = "v3",
                         segment_index: bool = False, pipeline_groups: int = 1,
                         device=None):
    """Returns ``fn(blocks u8[B, N], lens i32[B]) -> (outs: list[np.uint8],
    out_lens[B], checks[B][, seg_index[B, S]])``, the step
    ``BlockParallelEncoder`` expects; ``checks`` are adler32 (zlib) or
    crc32 (gzip) of each block. ``device`` defaults to CUDA; a CPU device
    runs every kernel's plain twin. ``pipeline_groups`` > 1 encodes the
    batch in that many groups, one after another on one stream.
    ``kernel="v3"`` (the default) writes dynamic, fixed or stored blocks
    with the device ladder's lex matcher; ``"v2"`` fixed-Huffman blocks
    only, matched at depth ``min(HOST_DEPTH[level], 8)``.
    ``fn.last_timings`` holds the last call's breakdown in milliseconds."""
    if kernel == "v1":
        raise NotImplementedError(
            "kernel='v1' (the chain-walk encode) is not ported, by design: use 'v3' or 'v2'")
    if kernel not in ("v2", "v3"):
        raise ValueError(f"unknown kernel {kernel!r}")
    device = torch.device("cuda" if device is None else device)
    lvl = max(1, min(9, level))
    wcap, vkeys, vstride = DEV_WCAP[lvl], DEV_KEYS[lvl], DEV_STRIDE[lvl]
    vdepth = DEV_DEPTH[lvl] if kernel == "v3" else min(HOST_DEPTH[lvl], 8)
    check = "crc" if mode is ZlibMode.Gzip else "adler"

    def fn(blocks: np.ndarray, lens: np.ndarray):
        t_start = time.perf_counter()
        B, N = blocks.shape
        G = pipeline_groups if (pipeline_groups > 1 and B % pipeline_groups == 0
                                and B >= 2 * pipeline_groups) else 1
        gb = B // G
        lens_dev = torch.from_numpy(np.asarray(lens, np.int64)).to(device)
        parts = []
        for g in range(G):
            dev_blocks = torch.from_numpy(
                np.ascontiguousarray(blocks[g * gb:(g + 1) * gb])).to(device)
            parts.append(_encode_blocks_batched(
                dev_blocks, lens_dev[g * gb:(g + 1) * gb], depth=vdepth,
                with_index=segment_index, check=check, wcap=wcap,
                stride=vstride, lex_keys=vkeys, kernel=kernel))
        small = [p[1].reshape(-1) for p in parts]
        if segment_index:
            small += [p[2].reshape(-1) for p in parts]
        t_dispatched = time.perf_counter()
        small_h = torch.cat(small).cpu().numpy()  # sync 1 (small)
        t_meta = time.perf_counter()
        meta_host = small_h[: 2 * B].reshape(B, 2)
        out_lens = meta_host[:, 0].astype(np.int32)
        checks = meta_host[:, 1].astype(np.uint32)
        seg_index = (small_h[2 * B:].reshape(B, -1).astype(np.int32)
                     if segment_index else None)
        # Each group's buffer holds its own compacted prefix: fetch those.
        flat = np.concatenate([
            parts[g][0][: int(out_lens[g * gb:(g + 1) * gb].sum())].cpu().numpy()
            for g in range(G)])  # sync 2 (exact bytes)
        t_payload = time.perf_counter()
        offsets = np.concatenate([[0], np.cumsum(out_lens)])
        out = [flat[offsets[i]: offsets[i + 1]] for i in range(B)]
        if mode is ZlibMode.Gzip:
            # meta carries the raw init-0 register of the padded block: fold
            # in the init register, strip the pad, finalize.
            front = checksum.crc_shift(0xFFFFFFFF, N)
            crcs = np.empty(B, dtype=np.uint32)
            for i in range(B):
                reg = checksum.crc_unshift(front ^ int(checks[i]), N - int(lens[i]))
                crcs[i] = reg ^ 0xFFFFFFFF
            checks = crcs
        # h2d_dispatch: upload and enqueue (asynchronous on CUDA);
        # sync_meta: the first wait on the device, so it carries the kernel
        # time; payload_d2h: the compressed-bytes fetch; host_asm: split
        # and checksum finishing.
        fn.last_timings = {
            "h2d_dispatch_ms": round(1e3 * (t_dispatched - t_start), 1),
            "sync_meta_ms": round(1e3 * (t_meta - t_dispatched), 1),
            "payload_d2h_ms": round(1e3 * (t_payload - t_meta), 1),
            "host_asm_ms": round(1e3 * (time.perf_counter() - t_payload), 1),
        }
        if segment_index:
            return out, out_lens, checks, seg_index
        return out, out_lens, checks

    return fn
