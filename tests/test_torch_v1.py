"""The v1 block encode (``kernels/deflate_v1.py``, the chain walk and
fixed-Huffman blocks), its block step (``make_block_encode_fn(kernel=
"v1")``) and ``byte_histogram`` (``kernels/histogram.py``), against the
JAX package's (``compu_tpu``) on the CPU.

Bytes, lengths and checks are integers, so every comparison is exact
(tolerance 0). The reference's v1 block step raises (it reads a name its
v1 branch never binds), so the port's step is held to the reference block
by block through ``encode_block_fixed``, and its checks to stdlib zlib.
The tests marked ``gpu`` hold the card's results to the CPU's. Inputs are
made from a numpy seed.
"""

import pathlib
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import BlockParallelEncoder, ZlibMode, make_block_encode_fn  # noqa: E402
from compu_tpu_torch.kernels import block_codec  # noqa: E402
from compu_tpu_torch.kernels.deflate_v1 import encode_block_fixed, encode_blocks_fixed  # noqa: E402
from compu_tpu_torch.kernels.histogram import byte_histogram  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
N = 1 << 14
CAP = N + N // 4 + 64


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def text(n: int, seed: int) -> bytes:
    """alice29 cut at seeded offsets, with runs of one byte."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        k = int(rng.integers(100, 3000))
        if rng.random() < 0.1:
            out += bytes([int(rng.integers(0, 256))]) * k
        else:
            at = int(rng.integers(0, len(ALICE) - k))
            out += ALICE[at:at + k]
    return bytes(out[:n])


BLOCKS = {
    "n1": b"Q",
    "n3": b"abc",
    "short": text(1000, 1),
    "full": text(N, 2),
    "zeros": bytes(N),
    "random": np.random.default_rng(3).integers(0, 256, N, dtype=np.uint8).tobytes(),
}
LEVELS = {1: (1, 8, False), 4: (4, 32, True), 6: (8, 128, True), 9: (32, 258, True)}


def padded(data: bytes) -> np.ndarray:
    """The block in an N-byte buffer, the pad of seeded garbage (the
    encode must not read past the block's length)."""
    buf = np.random.default_rng(len(data)).integers(0, 256, N, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return buf


@pytest.mark.parametrize("name", list(BLOCKS))
@pytest.mark.parametrize("level", list(LEVELS))
def test_encode_block_fixed_equals_reference(jax_cpu, level, name):
    """The bytes up to ``meta[0]``, and ``meta`` = [out_len, adler32], equal
    the reference's; the block inflates; past ``meta[0]`` both are 0."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax import encode_block_fixed as ref_encode

    depth, nice, lazy = LEVELS[level]
    data = BLOCKS[name]
    buf = padded(data)
    out, meta = encode_block_fixed(torch.from_numpy(buf), len(data), depth=depth, nice=nice,
                                   lazy=lazy, cap=CAP)
    r_out, r_meta = ref_encode(jnp.asarray(buf), jnp.int32(len(data)), depth=depth, nice=nice,
                               lazy=lazy, cap=CAP)
    out, meta, r_out, r_meta = out.numpy(), meta.numpy(), np.asarray(r_out), np.asarray(r_meta)
    assert meta.dtype == np.int32 and np.array_equal(meta, r_meta)
    assert np.array_equal(out, r_out)
    assert int(meta[1]) & 0xFFFFFFFF == zlib.adler32(data)
    assert zlib.decompressobj(-15).decompress(out[:meta[0]].tobytes()) == data


def test_batch_equals_blocks_one_by_one():
    """A (B, N) batch gives each block's own encode: other blocks' lanes
    never change a block's bytes."""
    names = list(BLOCKS)
    blocks = np.stack([padded(BLOCKS[k]) for k in names])
    lens = torch.tensor([len(BLOCKS[k]) for k in names])
    outs, metas = encode_blocks_fixed(torch.from_numpy(blocks), lens, cap=CAP)
    for i in range(len(names)):
        out, meta = encode_block_fixed(torch.from_numpy(blocks[i]), int(lens[i]), cap=CAP)
        assert torch.equal(outs[i], out) and torch.equal(metas[i], meta)


def _corpus_blocks(count: int):
    data = b"".join(text(N, 10 + i) for i in range(count - 1)) + text(N // 3, 99)
    blocks = np.zeros((count, N), np.uint8)
    lens = np.zeros(count, np.int32)
    for i in range(count):
        piece = data[i * N:(i + 1) * N]
        blocks[i, :len(piece)] = np.frombuffer(piece, np.uint8)
        lens[i] = len(piece)
    return data, blocks, lens


@pytest.mark.parametrize("mode", [ZlibMode.Gzip, ZlibMode.Zlib])
def test_v1_step_checks_and_stream(jax_cpu, mode):
    """The v1 step (no longer refused): checks equal stdlib crc32 (from the
    lane registers) or adler32, each block equals the reference's
    ``encode_block_fixed``, and the stream decodes."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax import encode_block_fixed as ref_encode

    data, blocks, lens = _corpus_blocks(4)
    fn = make_block_encode_fn(mode, 6, kernel="v1", device="cpu")
    out, out_lens, checks = fn(blocks, lens)
    for i in range(len(lens)):
        piece = blocks[i, :lens[i]].tobytes()
        want = zlib.crc32(piece) if mode is ZlibMode.Gzip else zlib.adler32(piece)
        assert int(checks[i]) == want
        r_out, r_meta = ref_encode(jnp.asarray(blocks[i]), jnp.int32(int(lens[i])), depth=8,
                                   nice=128, lazy=True, cap=CAP)
        assert int(out_lens[i]) == int(r_meta[0])
        assert out[i].tobytes() == np.asarray(r_out)[: int(r_meta[0])].tobytes()
    stream, _ = BlockParallelEncoder(fn, block_size=N, mode=mode).encode(data)
    assert zlib.decompress(stream, wbits=31 if mode is ZlibMode.Gzip else 15) == data


def test_v1_step_refusals_and_warm():
    """v1 has no segment index; its lane crc needs N a multiple of the
    lane count; ``warm`` runs the device work once."""
    with pytest.raises(ValueError, match="segment index"):
        make_block_encode_fn(ZlibMode.Gzip, kernel="v1", segment_index=True, device="cpu")
    fn = make_block_encode_fn(ZlibMode.Gzip, kernel="v1", crc_lanes=1024, device="cpu")
    with pytest.raises(ValueError, match="multiple of 1024"):
        fn(np.zeros((1, 1000), np.uint8), np.array([10], np.int32))
    assert block_codec._LEVEL[6] == (8, 128, True)
    block_codec.warm(4096, 6, "cpu")


@pytest.mark.parametrize("n", [1, 1000, 65536])
def test_byte_histogram_equals_reference(jax_cpu, n):
    import jax.numpy as jnp

    from compu_tpu.kernels.pallas_kernels import byte_histogram as ref_histogram

    block = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    block[: n // 3] = 7  # a skewed bin
    got = byte_histogram(torch.from_numpy(block))
    assert got.dtype == torch.float32 and got.shape == (256,)
    assert np.array_equal(got.numpy(), np.asarray(ref_histogram(jnp.asarray(block))))
    assert np.array_equal(got.numpy(), np.bincount(block, minlength=256))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", [ZlibMode.Gzip, ZlibMode.Zlib])
def test_v1_step_card_equals_cpu_gpu(cuda, mode):
    _, blocks, lens = _corpus_blocks(8)
    got = make_block_encode_fn(mode, 6, kernel="v1")(blocks, lens)
    want = make_block_encode_fn(mode, 6, kernel="v1", device="cpu")(blocks, lens)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got[0], want[0]))


@pytest.mark.gpu
def test_byte_histogram_card_gpu(cuda):
    block = np.random.default_rng(5).integers(0, 256, 1 << 20, dtype=np.uint8)
    got = byte_histogram(torch.from_numpy(block).to(cuda)).cpu().numpy()
    assert np.array_equal(got, np.bincount(block, minlength=256))
