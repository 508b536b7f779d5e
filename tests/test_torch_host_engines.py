"""The scheduler's two host engines (``parallel/scheduler.py``) against the
JAX package's (``compu_tpu``) on the CPU: ``make_host_block_encode_fn``
(one host-runtime deflate call a block, in a thread pool, behind
``BlockParallelEncoder``) and ``parallel_zstd_compress`` (one host-runtime
zstd frame a slice). Outputs are bytes and checks integers, so every
comparison is exact; ``tests/test_parallel.py``'s host-engine cases are
ported here. Inputs are made from a numpy seed.
"""

import io
import pathlib
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import BlockParallelDecoder, BlockParallelEncoder, ByteVec, ZlibMode  # noqa: E402
from compu_tpu_torch import decoder  # noqa: E402
from compu_tpu_torch.parallel.scheduler import (  # noqa: E402
    make_host_block_encode_fn,
    parallel_zstd_compress,
)

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()


def blocks_of(data: bytes, bs: int):
    nb = max(1, -(-len(data) // bs))
    blocks = np.zeros((nb, bs), np.uint8)
    lens = np.zeros(nb, np.int32)
    for i in range(nb):
        piece = data[i * bs:(i + 1) * bs]
        blocks[i, :len(piece)] = np.frombuffer(piece, np.uint8)
        lens[i] = len(piece)
    return blocks, lens


def sample(n: int, seed: int) -> bytes:
    """Text cut from alice29 at seeded offsets, with runs and noise."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        k = int(rng.integers(200, 5000))
        if rng.random() < 0.2:
            out += rng.integers(0, 256, k // 8, dtype=np.uint8).tobytes()
        else:
            at = int(rng.integers(0, len(ALICE) - k))
            out += ALICE[at:at + k]
    return bytes(out[:n])


@pytest.mark.parametrize("workers", [None, 1])
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("mode", ["Gzip", "Zlib"])
def test_host_block_step_equals_reference(mode, level, workers):
    """Per-block outputs, lengths and checks equal the reference's engine;
    checks equal stdlib crc32/adler32; each block inflates on its own."""
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.parallel.scheduler import make_host_block_encode_fn as ref_fn

    data = sample(150_000, level) + b"\x00" * 3
    blocks, lens = blocks_of(data, 1 << 15)
    out, out_lens, checks = make_host_block_encode_fn(ZlibMode[mode], level, workers)(blocks, lens)
    r_out, r_lens, r_checks = ref_fn(RefMode[mode], level, workers)(blocks, lens)
    assert np.array_equal(out_lens, r_lens) and np.array_equal(checks, r_checks)
    assert checks.dtype == np.uint32 and out_lens.dtype == np.int64
    for i in range(len(lens)):
        assert out[i].tobytes() == r_out[i].tobytes()
        piece = blocks[i, :lens[i]].tobytes()
        want = zlib.adler32(piece) if mode == "Zlib" else zlib.crc32(piece)
        assert int(checks[i]) == want
        assert zlib.decompressobj(-15).decompress(out[i].tobytes()) == piece


def test_host_block_encode_engine():
    """Threaded host encode engine behind the same scheduler contract:
    standard gzip out, stock-zlib accepted, the index decodes block by
    block on the host."""
    data = ALICE * 3
    fn = make_host_block_encode_fn(ZlibMode.Gzip, level=6)
    enc = BlockParallelEncoder(fn, block_size=1 << 17, mode=ZlibMode.Gzip)
    stream, index = enc.encode(data)
    assert zlib.decompress(stream, wbits=31) == data
    dec = BlockParallelDecoder(host=True, block_size=1 << 17)
    assert dec.decode(stream, index) == data
    # zlib framing too
    fnz = make_host_block_encode_fn(ZlibMode.Zlib, level=6)
    encz = BlockParallelEncoder(fnz, block_size=1 << 17, mode=ZlibMode.Zlib)
    sz, _ = encz.encode(data)
    assert zlib.decompress(sz) == data


@pytest.mark.parametrize("case", [(3, 1 << 17, 21, True), (1, 1 << 16, 17, False),
                                  (19, 1 << 18, 20, True)])
def test_parallel_zstd_equals_reference(case):
    """The multi-frame stream equals the reference's, with the pool and
    serially; zstandard reads every frame."""
    import zstandard

    from compu_tpu.parallel.scheduler import parallel_zstd_compress as ref_compress

    level, frame_size, window_log, chk = case
    data = sample(400_000, level)
    kw = dict(level=level, frame_size=frame_size, window_log=window_log, checksum_frames=chk)
    stream = parallel_zstd_compress(data, **kw)
    assert stream == ref_compress(data, **kw)
    assert parallel_zstd_compress(data, workers=1, **kw) == stream
    r = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(stream), read_across_frames=True)
    assert r.read(len(data) + 64) == data


def test_parallel_zstd_frames():
    """Frame-parallel zstd: independent frames concatenate into a standard
    multi-frame stream that the foreign streaming decoder and both of the
    port's decoders accept (Finished fires per frame; the caller resets
    and continues on the remaining input)."""
    import zstandard

    data = ALICE * 4
    stream = parallel_zstd_compress(data, level=3, frame_size=1 << 17)
    r = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(stream), read_across_frames=True)
    assert r.read(len(data) + 64) == data
    from compu_tpu_torch.formats.zstd.options import ZstdDecodeOptions

    host = ZstdDecodeOptions(device_literals=False)
    for mk in (lambda: decoder.Interface.zstd(host, device="cpu"), decoder.Interface.zstd_native):
        d = mk()
        out = bytearray()
        rest = memoryview(stream)
        while len(rest):
            vec = ByteVec()
            res = d.decode_vec_full(bytes(rest), vec)
            assert res.status is decoder.DecodeStatus.Finished, res
            out += vec.data()
            rest = rest[len(rest) - res.input_remain:]
            assert d.reset()
        assert bytes(out) == data


def test_parallel_zstd_empty_input():
    """An empty input is one empty frame, as the reference's."""
    import zstandard

    from compu_tpu.parallel.scheduler import parallel_zstd_compress as ref_compress

    stream = parallel_zstd_compress(b"")
    assert stream == ref_compress(b"")
    assert zstandard.ZstdDecompressor().decompress(stream, max_output_size=16) == b""
