"""The zstd 4-stream Huffman literals on the device (RFC 8878 §3.1.1.3).

Port of ``compu_tpu/kernels/zstd_literals_jax.py`` (``_encode_streams``,
``encode_streams_device``), in plain PyTorch: it has no kernel of its own.
The host builds the tree (a 256-symbol histogram to 11-bit-capped
lengths, already done for the description header); the device does the
per-byte work for all four streams at once. A zstd Huffman stream is a
backward bitstream, whose LSB-first bytes are the forward pack of the
reversed symbols: a reversed gather, code and width gathers, an exclusive
cumsum of the widths, three byte-lane scatter-adds and the sentinel bit.
The bytes equal the host ``BackwardBitWriter``'s.
"""

from __future__ import annotations

import numpy as np
import torch


def _encode_streams(mat: torch.Tensor, counts: torch.Tensor, code: torch.Tensor,
                    nbits: torch.Tensor, *, cap: int):
    """``mat`` (S, P) uint8 symbols (padded), ``counts`` (S,), ``code`` and
    ``nbits`` (256,). Returns (out (S, cap) uint8, nbytes (S,))."""
    S, P = mat.shape
    dev = mat.device
    pos = torch.arange(P, device=dev)[None, :]
    n = counts.to(torch.int64)[:, None]
    # Backward stream == forward pack of the reversed sequence.
    rev = mat.to(torch.int64).gather(1, torch.clamp(n - 1 - pos, 0, P - 1))
    valid = pos < n
    nb = torch.where(valid, nbits.to(torch.int64)[rev], 0)
    cd = torch.where(valid, code.to(torch.int64)[rev], 0)
    off = torch.cumsum(nb, 1) - nb  # exclusive prefix per stream
    total = nb.sum(1)
    shifted = cd << (off & 7)
    bytep = off >> 3
    out = torch.zeros(S, cap, dtype=torch.int64, device=dev)
    for k in range(3):  # fields are <= 11 bits + 7 phase = 18 bits = 3 bytes
        val = torch.where(valid, (shifted >> (8 * k)) & 0xFF, 0)
        out.scatter_add_(1, torch.clamp(bytep + k, 0, cap - 1), val)
    # sentinel bit on top of each stream, then pad to a byte
    out.scatter_add_(1, torch.clamp(total >> 3, 0, cap - 1)[:, None],
                     (1 << (total & 7))[:, None])
    nbytes = (total + 8) // 8
    return (out & 0xFF).to(torch.uint8), nbytes


def encode_streams_device(chunks: list[bytes], code: np.ndarray,
                          nbits: np.ndarray, device) -> list[bytes]:
    """Encode up to 4 literal streams on ``device``; returns the stream
    blobs (byte-identical to BackwardBitWriter). ``code``/``nbits`` may
    cover fewer than 256 symbols; they are padded."""
    S = len(chunks)
    per = max(len(c) for c in chunks)
    # symbol widths in 4 KiB buckets, as the reference's compiled shapes
    P = max(4096, (per + 4095) // 4096 * 4096)
    cap = (P * 11 + 7) // 8 + 8
    mat = np.zeros((4, P), dtype=np.uint8)
    counts = np.zeros(4, dtype=np.int32)
    for i, c in enumerate(chunks):
        mat[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        counts[i] = len(c)
    code_full = np.zeros(256, dtype=np.int64)
    nbits_full = np.zeros(256, dtype=np.int64)
    code_full[: len(code)] = code
    nbits_full[: len(nbits)] = nbits
    out, nbytes = _encode_streams(
        torch.from_numpy(mat).to(device), torch.from_numpy(counts).to(device),
        torch.from_numpy(code_full).to(device), torch.from_numpy(nbits_full).to(device),
        cap=cap)
    nbytes = nbytes.cpu().numpy()
    out = out[:, : int(nbytes.max())].cpu().numpy()
    return [out[i, : int(nbytes[i])].tobytes() for i in range(S)]
