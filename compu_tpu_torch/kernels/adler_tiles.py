"""Tiled device adler32: per-tile partial sums, combined on the host.

Port of the adler half of ``compu_tpu/kernels/pallas_kernels.py``
(``adler32_partials``, ``adler32_pallas``). For tile t of ``TILE`` bytes
x_0..x_{TILE-1}, the partials are ``[sum x_k, sum x_k * (TILE - k)]``, exact
in int32. The port's contract drops the reference's (8, 128) Mosaic page:
``adler32_partials`` returns (T, 2) int32, where the reference's values sat
at ``out[:, 0, :2]``. The input is any flat run of whole tiles, so one launch
covers a flattened batch of blocks: ``adler32_device`` takes a (B, N) batch
and makes one launch a pass.

``adler32_partials`` dispatches by device: the CUDA kernel
(``csrc/adler_tiles.cu``) for a CUDA tensor, the plain twin
``adler32_partials_torch`` for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import ADLER_MOD

TILE = 1024  # bytes per tile, as the reference's


def _check(data: torch.Tensor) -> int:
    """The tile count of a flat uint8 run of whole tiles."""
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"expected a flat uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    if data.shape[0] % TILE:
        raise ValueError(f"{data.shape[0]} bytes are not whole tiles of {TILE}")
    return data.shape[0] // TILE


def adler32_partials_torch(data: torch.Tensor) -> torch.Tensor:
    """Plain twin: (T*TILE,) uint8 -> (T, 2) int32 [byte sum, weighted sum]."""
    _check(data)
    tiles = data.reshape(-1, TILE).to(torch.int32)
    weight = TILE - torch.arange(TILE, device=data.device, dtype=torch.int32)
    return torch.stack([tiles.sum(-1), (tiles * weight).sum(-1)], -1).to(torch.int32)


def adler32_partials_cuda(data: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/adler_tiles.cu``); same contract as
    :func:`adler32_partials_torch`. The kernel reads 16-byte vectors, so
    ``data`` must start on a 16-byte boundary."""
    from .. import _build

    _build.require(data, "data", ndim=1, dtype=torch.uint8)
    ntiles = _check(data)
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary")
    out = torch.empty(ntiles, 2, dtype=torch.int32, device=data.device)
    err = _build.lib().compu_adler_tiles(data.data_ptr(), out.data_ptr(), ntiles,
                                         _build.stream_handle(data))
    _build.check_launch(err, "adler_tiles")
    return out


def adler32_partials(data: torch.Tensor) -> torch.Tensor:
    """Per-tile adler32 partials: the kernel on CUDA, the twin on the CPU."""
    kind = data.device.type
    if kind == "cuda":
        return adler32_partials_cuda(data)
    if kind == "cpu":
        return adler32_partials_torch(data)
    raise ValueError(f"no adler32_partials for device {data.device}")


def adler32_device(blocks: torch.Tensor, lens):
    """adler32 of each ``blocks[i, :lens[i]]`` of a (B, N) uint8 batch, from
    one ``adler32_partials`` launch over the flat B*N run and one fetch;
    returns a list of B ints. ``lens`` is a sequence of ints or a (B,)
    integer tensor on any device. A single (N,) block with an int length is
    the case B == 1 and returns an int.

    Each block is zero past its length. The host combines its tiles: A
    before tile t is 1 plus the byte sums of the tiles before it, and B is
    the sum of ``TILE * A_t + w_t``, both mod 65521. The padding's only
    effect, advancing B by A once per zero byte, is taken back
    algebraically."""
    if blocks.dim() == 1:
        return adler32_device(blocks[None], [lens])[0]
    B, N = blocks.shape
    parts = adler32_partials(blocks.reshape(-1)).cpu().numpy().astype(np.int64)
    parts = parts.reshape(B, N // TILE, 2)
    s, w = parts[..., 0], parts[..., 1]
    a_before = 1 + np.cumsum(s, axis=1) - s
    b = np.sum(TILE * (a_before % ADLER_MOD) + w, axis=1) % ADLER_MOD
    a = (1 + s.sum(axis=1)) % ADLER_MOD
    if isinstance(lens, torch.Tensor):
        lens = lens.cpu().numpy()
    pad = N - np.asarray(lens, dtype=np.int64).reshape(B)
    b = (b - pad * a) % ADLER_MOD
    return [int(x) for x in (b << 16) | a]
