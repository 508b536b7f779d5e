"""Segment-local bit pack of the emit stage.

Port of ``emit_pallas.emit_pack_pallas`` / ``emit_pack_xla`` followed by
``rows_from_tiles``: the contract is the (S, 512) int32 segment rows. Byte
k of ``shifted[s, f]`` (a u32 bit pattern) is added at row byte
``bytep[s, f] + k``; bytes at or past 512 are dropped, and so is a field
whose ``bytep`` lies outside [0, 512) — as the reference's one-hot form
drops it.

``emit_pack`` dispatches by device: the CUDA kernel (``csrc/emit_pack.cu``)
for a CUDA tensor, the plain twin ``emit_pack_torch`` (a scatter-add) for a
CPU tensor.
"""

from __future__ import annotations

import torch

from . import u32

W2 = 512  # segment row width in bytes


def emit_pack_torch(bytep: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """Plain twin: (S, F) int32 byte positions and (S, F) int32 u32 bit
    patterns -> (S, 512) int32 rows."""
    S = bytep.shape[0]
    p = bytep.to(torch.int64)
    v = u32.from_i32_bits(shifted)
    field_ok = (p >= 0) & (p < W2)
    rows = torch.zeros(S, W2 + 1, dtype=torch.int64, device=bytep.device)
    for k in range(4):
        idx = p + k
        ok = field_ok & (idx < W2)
        rows.scatter_add_(1, torch.where(ok, idx, W2),
                          torch.where(ok, (v >> (8 * k)) & 0xFF, 0))
    return rows[:, :W2].to(torch.int32)


def emit_pack_cuda(bytep: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/emit_pack.cu``); same contract as
    :func:`emit_pack_torch`."""
    from .. import _build

    _build.require(bytep, "bytep", ndim=2)
    _build.require(shifted, "shifted", ndim=2)
    if bytep.shape != shifted.shape or bytep.device != shifted.device:
        raise ValueError("bytep and shifted must match in shape and device")
    S, F = bytep.shape
    rows = torch.empty(S, W2, dtype=torch.int32, device=bytep.device)
    if S == 0:
        return rows
    err = _build.lib().compu_emit_pack(
        bytep.data_ptr(), shifted.data_ptr(), rows.data_ptr(), S, F,
        _build.stream_handle(bytep))
    _build.check_launch(err, "emit_pack")
    return rows


def emit_pack(bytep: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """Packed segment rows: the kernel on CUDA, the twin on the CPU."""
    kind = bytep.device.type
    if kind == "cuda":
        return emit_pack_cuda(bytep, shifted)
    if kind == "cpu":
        return emit_pack_torch(bytep, shifted)
    raise ValueError(f"no emit_pack for device {bytep.device}")
