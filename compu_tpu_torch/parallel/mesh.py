"""Multi-device distribution on ``torch.distributed``: blocks shard over
ranks, and only ordering metadata crosses between them.

Port of ``compu_tpu/parallel/mesh.py``. Compression has one natural
parallel axis, independent blocks, so the principal mesh axis is ``dp``:
each rank encodes its own blocks, and the ranks exchange

* an all-gather of the per-block compressed lengths (each rank then knows
  every block's output offset for ordered reassembly) and checksums;
* an all-reduce of the total compressed bytes.

A second ``lane`` axis shards one block's crc32 lane registers (checksum
algebra is associative, so lanes merge anywhere), and the zstd literal
step shards one block's four Huffman streams over ``dp``.

One process is one rank and one device. A mesh over CUDA tensors runs on
NCCL, one over CPU tensors on gloo, and nothing else: there is no switch
from one to the other. The caller starts the process group
(:func:`init_world`); importing this module starts nothing.

The reference's ``shard_map`` steps take and return global, sharded
arrays. These steps take the rank's own shard and return its local
outputs beside the gathered metadata, which is what a rank has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.checksum import crc32_lane_registers
from ..kernels.deflate_v3 import encode_blocks_dyn
from ..kernels.zstd_literals import _encode_streams

# all_gather_single is the current name; older PyTorch has only all_gather_into_tensor.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def backend_for(device) -> str:
    """The one backend a device's tensors go through: NCCL for CUDA, gloo
    for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def init_world(*, rank: int, world_size: int, init_method: str, device=None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://host:port``), on ``device`` (CUDA by default:
    the rank's own card, ``cuda:rank``). Returns the rank's device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card of its own: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def default_mesh(axis: str = "dp", device=None) -> DeviceMesh:
    """1-D mesh over every rank of the process group, on ``device``'s kind
    (CUDA by default)."""
    kind = torch.device("cuda" if device is None else device).type
    return init_device_mesh(kind, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather ``x`` over ``group`` along its first dimension."""
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, x, group=group)
    return out


def make_sharded_encode_step(mesh: DeviceMesh, *, depth: int = 8, nice: int = 128,
                             lazy: bool = True):
    """The multi-device block encode step. ``nice`` and ``lazy`` are
    accepted and not read, as in the reference.

    ``step(local_blocks u8[b, N], local_lens[b])`` with the same ``b`` on
    every rank of ``dp``: the rank encodes its blocks in one
    ``encode_blocks_dyn`` batch at ``depth=min(depth, 8)`` (the lex matcher,
    wcap 32, two sort keys, stride 1, adler32), then the lengths and adlers
    are all-gathered over ``dp`` in rank order and the total summed.
    Returns ``(local_outs u8[b, cap], out_lens i32[b * dp], adlers
    i32[b * dp] (u32 bit patterns), total)``, ``total`` an int64 0-dim
    tensor."""
    del nice, lazy
    group = mesh.get_group("dp")
    dev = _device(mesh)

    def step(local_blocks, local_lens):
        outs, metas = encode_blocks_dyn(torch.as_tensor(local_blocks, device=dev),
                                        torch.as_tensor(local_lens, device=dev),
                                        depth=min(depth, 8))
        out_lens = metas[:, 0]
        total = out_lens.sum(dtype=torch.int64)
        dist.all_reduce(total, group=group)
        return outs, all_gather_rows(out_lens, group), all_gather_rows(metas[:, 1], group), total

    return step


def make_stream_sharded_literal_step(mesh: DeviceMesh, *, cap: int):
    """One zstd block's four Huffman literal streams sharded over ``dp``
    (RFC 8878 §3.1.1.3: the streams are independent by design).

    ``step(mat u8[l, P], counts[l], code[256], nbits[256])``, the rank's
    ``l`` stream lanes (the same ``l`` on every rank) and the shared table:
    each rank packs its lanes (``zstd_literals._encode_streams``), and the
    streams and their lengths are all-gathered in rank order. Returns
    ``(streams u8[l * dp, cap], nbytes[l * dp])`` on every rank, as the
    reference's replicated outputs."""
    group = mesh.get_group("dp")
    dev = _device(mesh)

    def step(mat, counts, code, nbits):
        out, nb = _encode_streams(*(torch.as_tensor(x, device=dev)
                                    for x in (mat, counts, code, nbits)), cap=cap)
        return all_gather_rows(out, group), all_gather_rows(nb, group)

    return step


def make_lane_sharded_crc(mesh: DeviceMesh, *, lanes_per_device: int = 256):
    """crc32 lane registers of one block with its lanes sharded over the
    ``lane`` axis of a 2-D ``("dp", "lane")`` mesh.

    ``step(block_slice u8[1, M])``, the rank's contiguous slice of the block
    (slice ``mesh.get_local_rank("lane")`` of ``mesh.size(1)`` equal ones):
    the rank's ``lanes_per_device`` raw lane registers
    (``crc32_lane_registers``), all-gathered over ``lane``. Returns the
    block's (1, lanes_per_device * lane) int64 u32 registers, in lane
    order; the host folds them (``ops.checksum.fold_lane_registers``)."""
    group = mesh.get_group("lane")
    dev = _device(mesh)

    def step(block_slice):
        regs = crc32_lane_registers(torch.as_tensor(block_slice, device=dev).reshape(1, -1),
                                    lanes=lanes_per_device)
        return all_gather_rows(regs[0], group)[None]

    return step
