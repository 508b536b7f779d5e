"""The shared device LZ stage feeding a host entropy coder.

The port's copy of ``compu_tpu/formats/device_lz.py``. zstd (and, later,
brotli) consume the DEFLATE encode's match and parse stage as a token
cover, ``(tok_pos, tok_len, tok_dist)``: one token per literal byte or
match, in position order, partitioning ``[0, n)``.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceTokenizer:
    """Pads each chunk to ``block_size`` bytes and runs the LZ stage on
    ``device`` (CUDA by default; ``"cpu"`` runs the kernels' plain
    versions).

    ``block_size`` must be a power of two, as every block of the port's
    LZ stage: its kernels mask neighbours by ``lane & (block_size - 1)``.
    The cover depends on ``block_size`` (it sets the sort's extent), so a
    short final chunk is still padded to the full size, as the reference
    does. Matches reach at most ``min(max_dist, block_size)`` back.
    """

    def __init__(self, block_size: int, max_dist: int, depth: int = 8,
                 device=None) -> None:
        if block_size <= 0 or block_size & (block_size - 1):
            raise ValueError(f"block_size must be a power of two, got {block_size}")
        self.block_size = block_size
        self.max_dist = min(max_dist, block_size)
        self.depth = depth
        self.device = torch.device("cuda" if device is None else device)

    def __call__(self, data: bytes):
        from ..kernels.deflate_v2 import device_match_tokens, device_tokens

        n = len(data)
        if n > self.block_size:
            raise ValueError(f"{n} bytes exceed the block of {self.block_size}")
        padded = np.zeros(self.block_size, dtype=np.uint8)
        padded[:n] = np.frombuffer(data, dtype=np.uint8)
        dev = torch.from_numpy(padded).to(self.device)
        # Matches only cross to the host (8 bytes a match); the literal
        # tokens are the positions no match covers. When the matches do not
        # fit the buffer (count > cap: covers of mostly minimum-length
        # matches), the dense per-position form is fetched instead.
        packed, count = device_match_tokens(dev, n, depth=self.depth,
                                            max_dist=self.max_dist)
        count = int(count)
        if count <= packed.shape[0]:
            v = packed[:count].cpu().numpy().astype(np.int64)
            mpos = v[:, 0] & 0xFFFFF
            mlen = (v[:, 0] >> 20) & 0x1FF
            mdist = v[:, 1] & 0x1FFFFF
            # covered[i] > 0 inside a match span; token starts = match
            # positions plus every uncovered position (a literal each)
            delta = np.zeros(n + 1, dtype=np.int32)
            np.add.at(delta, mpos, 1)
            np.add.at(delta, np.minimum(mpos + mlen, n), -1)
            covered = np.cumsum(delta[:n]) > 0
            lit_pos = np.nonzero(~covered)[0].astype(np.int64)
            tok_pos = np.concatenate([lit_pos, mpos])
            tok_len = np.concatenate([np.zeros(len(lit_pos), np.int64), mlen])
            tok_dist = np.concatenate([np.zeros(len(lit_pos), np.int64), mdist])
            order = np.argsort(tok_pos, kind="stable")
            return tok_pos[order], tok_len[order], tok_dist[order]
        packed = device_tokens(dev, n, depth=self.depth,
                               max_dist=self.max_dist).cpu().numpy()[:n]
        tok_pos = np.nonzero(packed & 1)[0].astype(np.int64)
        v = packed[tok_pos].astype(np.int64)
        tok_len = (v >> 1) & 0x1FF
        tok_dist = (v >> 10) & 0x1FFFFF
        return tok_pos, tok_len, tok_dist
