"""The port's ``BlockParallelDecoder`` against the JAX reference's, on the
CPU: gzip and zlib streams of the block encode at levels 4 and 6 (the
shapes of the reference's own oracles, ``tests/test_parallel.py:80`` and
``tests/test_v3_kernel.py:103``) over a corpus of stored, fixed and
dynamic blocks, decoded by the port with ``device="cpu"`` (kernel P3's
plain version) and by the reference with ``device=True,
host_fallback=False``; the decoder's rules (a corrupt stream raises, no
host fallback, the device route needs the segment index, ``host=True``
decodes with stdlib ``zlib``), the stored-block copy, and, marked ``gpu``,
the card's decode equal to the CPU's.

Streams come from the port's block encode on the CPU, which gives the
reference encoder's bytes (checked here on the corpus and on the cases of
``tests/test_torch_inflate.py``). Every comparison is of bytes (exact).
"""

import functools
import pathlib
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import (  # noqa: E402
    BlockParallelDecoder,
    BlockParallelEncoder,
    ZlibMode,
    _build,
    make_block_encode_fn,
)
from compu_tpu_torch.parallel import scheduler  # noqa: E402
from compu_tpu_torch.parallel.scheduler import BlockIndex, BlockState  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
BS = 1 << 15


def corpus(bs: int = BS, blocks: int = 18) -> bytes:
    """Text blocks (dynamic), noise blocks (stored), one block of runs, and
    a short tail (a fixed block); more than one batch of 16 blocks."""
    rng = np.random.default_rng(5)
    parts = []
    for i in range(blocks - 1):
        if i % 5 == 3:
            parts.append(rng.integers(0, 256, bs, dtype=np.uint8).tobytes())
        elif i == 7:
            parts.append(b"xyz" * (bs // 3) + b"x" * (bs % 3))
        else:
            at = (i * 7919) % (len(TEXT) - bs)
            parts.append(TEXT[at:at + bs])
    return b"".join(parts) + TEXT[:100]


@functools.lru_cache(maxsize=None)
def port_stream(mode: ZlibMode, level: int, bs: int = BS):
    data = corpus(bs, 18 if bs == BS else 5)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fn = make_block_encode_fn(mode, level=level, segment_index=True, device="cpu")
        stream, index = BlockParallelEncoder(fn, block_size=bs, mode=mode).encode(data)
    finally:
        torch.set_num_threads(threads)
    return data, stream, index


def ref_index(index):
    from compu_tpu.parallel.scheduler import BlockIndex as RefIndex

    return RefIndex(list(index.raw_lengths), list(index.compressed_offsets),
                    list(index.compressed_lengths), list(index.segment_bits))


@pytest.fixture
def ref(monkeypatch):
    """The reference's scheduler, on the CPU, with its native host helpers
    off (its stored blocks take its pure-Python inflate)."""
    pytest.importorskip("jax")
    from compu_tpu.parallel import scheduler as ref_scheduler
    from compu_tpu.runtime import native

    monkeypatch.setattr(native, "_load", lambda: None)
    return ref_scheduler


def test_corpus_has_every_kind_of_block():
    from compu_tpu_torch.kernels.inflate_dyn import parse_block_tables

    _, stream, index = port_stream(ZlibMode.Gzip, 6)
    kinds = [parse_block_tables(stream[o:o + 4096])[0] for o in index.compressed_offsets]
    assert {0, 1, 2} <= set(kinds)
    assert len(kinds) > BlockParallelDecoder.DEVICE_DECODE_BATCH
    assert index.raw_lengths[-1] % 128


@pytest.mark.parametrize("mode", [ZlibMode.Gzip, ZlibMode.Zlib])
@pytest.mark.parametrize("level", [4, 6])
def test_decoder_equals_reference(ref, mode, level):
    data, stream, index = port_stream(mode, level)
    wbits = 31 if mode is ZlibMode.Gzip else 15
    assert zlib.decompress(stream, wbits=wbits) == data
    dec = BlockParallelDecoder(block_size=BS, device="cpu")
    got = dec.decode(stream, index)
    want = ref.BlockParallelDecoder(device=True, block_size=BS,
                                    host_fallback=False).decode(stream, ref_index(index))
    assert got == want == data
    assert all(st.state == BlockState.Ok for st in dec.block_statuses)


def test_decoder_at_block_size_2_17_equals_reference(ref):
    data, stream, index = port_stream(ZlibMode.Gzip, 6, 1 << 17)
    got = BlockParallelDecoder(block_size=1 << 17, device="cpu").decode(stream, index)
    want = ref.BlockParallelDecoder(device=True, block_size=1 << 17,
                                    host_fallback=False).decode(stream, ref_index(index))
    assert got == want == data


def test_port_streams_are_the_reference_encoders(ref):
    """The streams these tests and tests/test_torch_inflate.py decode are
    the reference encoder's bytes: the corpus at level 6, and the cases."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import test_torch_inflate as cases
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn as ref_fn

    data, stream, index = port_stream(ZlibMode.Gzip, 6)
    enc = ref.BlockParallelEncoder(ref_fn(RefMode.Gzip, level=6, segment_index=True),
                                   block_size=BS, mode=RefMode.Gzip, host_fallback=False)
    want, want_index = enc.encode(data)
    assert stream == want
    for b in range(len(index.raw_lengths)):
        np.testing.assert_array_equal(index.segment_bits[b], want_index.segment_bits[b])
    enc = ref.BlockParallelEncoder(ref_fn(RefMode.Gzip, level=6, segment_index=True),
                                   block_size=cases.BS, mode=RefMode.Gzip, host_fallback=False)
    for name in ("text", "runs", "far", "literals"):
        blob, seg, _, _ = cases.encoded(name)
        want, want_index = enc.encode(cases.case_data(name))
        assert want[want_index.compressed_offsets[0]:][:len(blob)] == blob
        np.testing.assert_array_equal(seg, want_index.segment_bits[0])


def _corrupt(stream: bytes, index, at: float) -> bytes:
    """``stream`` with one byte flipped at fraction ``at`` of its first
    dynamic block."""
    from compu_tpu_torch.kernels.inflate_dyn import parse_block_tables

    b = next(i for i, o in enumerate(index.compressed_offsets)
             if parse_block_tables(stream[o:o + 4096])[0] == 2)
    pos = index.compressed_offsets[b] + int(index.compressed_lengths[b] * at)
    bad = bytearray(stream)
    bad[pos] ^= 0xFF
    return bytes(bad)


def test_corrupt_stream_raises_in_both(ref):
    _, stream, index = port_stream(ZlibMode.Gzip, 6)
    bad = _corrupt(stream, index, 0.5)
    dec = BlockParallelDecoder(block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="consistency"):
        dec.decode(bad, index)
    assert all(st.state == BlockState.Failed for st in dec.block_statuses)
    with pytest.raises(ValueError, match="consistency"):
        ref.BlockParallelDecoder(device=True, block_size=BS,
                                 host_fallback=False).decode(bad, ref_index(index))


def test_host_fallback_is_refused():
    with pytest.raises(ValueError, match="no host fallback"):
        BlockParallelDecoder(block_size=BS, device="cpu", host_fallback=True)


def test_device_route_needs_segment_bits():
    _, stream, index = port_stream(ZlibMode.Gzip, 6)
    bare = BlockIndex.from_bytes(index.to_bytes())
    assert bare.segment_bits is None
    dec = BlockParallelDecoder(block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="segment_bits"):
        dec.decode(stream, bare)
    assert all(st.state == BlockState.Failed for st in dec.block_statuses)


def test_host_route_decodes_and_marks_the_bad_block():
    data, stream, index = port_stream(ZlibMode.Zlib, 4)
    bare = BlockIndex.from_bytes(index.to_bytes())
    assert BlockParallelDecoder(block_size=BS, host=True).decode(stream, bare) == data
    dec = BlockParallelDecoder(block_size=BS, host=True)
    with pytest.raises(Exception):
        dec.decode(_corrupt(stream, index, 0.02), bare)
    assert BlockState.Failed in {st.state for st in dec.block_statuses}


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, stream, index = port_stream(ZlibMode.Gzip, 6)
    dec = BlockParallelDecoder(block_size=BS)
    assert dec.device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        dec.decode(stream, index)
    assert all(st.state == BlockState.Failed for st in dec.block_statuses)


def test_stored_copy():
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    blob = b""
    for at in range(0, len(raw), 65535):
        chunk = raw[at:at + 65535]
        blob += bytes([0]) + len(chunk).to_bytes(2, "little") + \
            (len(chunk) ^ 0xFFFF).to_bytes(2, "little") + chunk
    blob += bytes([0, 0, 0, 0xFF, 0xFF])  # the sync flush
    assert scheduler._stored_copy(blob, len(raw)) == raw
    with pytest.raises(ValueError, match="expected"):
        scheduler._stored_copy(blob, len(raw) - 1)
    broken = bytearray(blob)
    broken[3] ^= 1
    with pytest.raises(ValueError, match="NLEN"):
        scheduler._stored_copy(bytes(broken), len(raw))
    with pytest.raises(ValueError, match="past the end"):
        scheduler._stored_copy(blob[:100], len(raw))
    with pytest.raises(ValueError, match="not stored"):
        scheduler._stored_copy(bytes([2]) + blob[1:], len(raw))


def test_block_size_must_be_a_multiple_of_128():
    with pytest.raises(ValueError, match="multiple of 128"):
        BlockParallelDecoder(block_size=1000, device="cpu")


@pytest.mark.gpu
def test_card_decoder_equals_cpu_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from compu_tpu_torch.utils.corpus import build_corpus

    data = build_corpus(2 << 20)
    fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True)
    stream, index = BlockParallelEncoder(fn, block_size=1 << 18, mode=ZlibMode.Gzip).encode(data)
    before = _build.LAUNCHES["inflate_scan"]
    got = BlockParallelDecoder(block_size=1 << 18).decode(stream, index)
    assert _build.LAUNCHES["inflate_scan"] == before + 1
    assert got == data
    assert BlockParallelDecoder(block_size=1 << 18, device="cpu").decode(stream, index) == got
