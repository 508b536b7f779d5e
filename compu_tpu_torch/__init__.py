"""compu_tpu_torch — the PyTorch/CUDA port of compu_tpu's device path.

The batched DEFLATE block encode (lexicographic LZ matching, exact greedy
cover, per-block dynamic Huffman trees, bit packing, checksums) and the
zstd encode run in PyTorch on a CUDA device, with hand-written CUDA
kernels (``csrc/``) for the stages the JAX package wrote in Pallas and for
its device loops; the zstd decoder decodes its 4-stream literal sections
there, and ``BlockParallelDecoder`` inflates the port's own gzip/zlib block
streams there, one lane per 128-byte segment of its index, and
``decoder.Interface.zlib_device`` inflates any deflate, zlib or gzip
stream there, 48 speculative lanes a 512-bit chunk. The brotli encoder
takes its LZ tokens from the same device stage and writes its prefix codes
on the host; the zstd and brotli encoders take the reference's host match
finders and parses instead when asked (``device_lz=False``). The brotli
decoder, ``Detection``, the stored format and the scheduler's host
engines are host code; the v1 block step is plain PyTorch on the device. The host backends are the reference's too: the Python DEFLATE
pair (``encoder.Interface.zlib``) and the C++ host runtime
(``runtime/native.py``, built with g++ at first use) with its zlib, zstd
and brotli pairs (``*_native``), whose helpers the zstd and brotli device
routes and the checksums call. The host layer (framing, the streaming
state machines, checksum algebra) is the port's own copy of
``compu_tpu``'s, under the same module names: the package imports nothing
of ``compu_tpu`` and nothing of JAX.
"""

from . import decoder, encoder
from .buffer import Buffer
from .detection import Detection
from .formats.deflate.options import ZlibDecodeOptions, ZlibMode, ZlibOptions
from .kernels.block_codec import make_block_encode_fn
from .parallel.scheduler import BlockParallelDecoder, BlockParallelEncoder
from .status import Decode, DecodeError, DecodeStatus
from .vec import ByteVec, ChunkedSink

__all__ = ["BlockParallelDecoder", "BlockParallelEncoder", "Buffer", "ByteVec", "ChunkedSink",
           "Decode", "DecodeError", "DecodeStatus", "Detection", "ZlibDecodeOptions", "ZlibMode",
           "ZlibOptions", "decoder", "encoder", "make_block_encode_fn"]
