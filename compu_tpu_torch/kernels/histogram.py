"""The 256-bin byte histogram of a block, on the block's device.

Port of ``compu_tpu/kernels/pallas_kernels.py``'s ``byte_histogram``,
which computes it with ``jnp`` outside any Pallas kernel (a one-hot matrix
product with float32 accumulation). Here it is one ``bincount``; the
counts are exact integers, returned as float32 as the reference's are,
which is exact below 2^24 per bin.
"""

from __future__ import annotations

import torch


def byte_histogram(block: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 -> (256,) float32 counts of each byte value."""
    return torch.bincount(block.reshape(-1).to(torch.int64), minlength=256).to(torch.float32)
