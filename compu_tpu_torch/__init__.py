"""compu_tpu_torch — the PyTorch/CUDA port of compu_tpu's device path.

The batched DEFLATE block encode (lexicographic LZ matching, exact greedy
cover, per-block dynamic Huffman trees, bit packing, checksums) runs in
PyTorch on a CUDA device, with hand-written CUDA kernels (``csrc/``) for
the stages the JAX package wrote in Pallas. The host layer (framing, the
streaming state machine, checksum algebra) is the port's own copy of
``compu_tpu``'s, under the same module names: the package imports
nothing of ``compu_tpu`` and nothing of JAX.
"""

from . import encoder
from .formats.deflate.options import ZlibMode, ZlibOptions
from .kernels.block_codec import make_block_encode_fn
from .parallel.scheduler import BlockParallelEncoder

__all__ = ["BlockParallelEncoder", "ZlibMode", "ZlibOptions", "encoder",
           "make_block_encode_fn"]
